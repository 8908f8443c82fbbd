"""Logical-axis sharding rules (port of ``repro.dist.sharding``).

Model code names tensor dimensions with *logical* axes ("batch", "mlp",
"fsdp", ...); this module maps them onto the named dimensions of a
``torch.distributed.device_mesh.DeviceMesh`` (pod / data / model, see
``repro_torch.launch.mesh``).  The mapping degrades gracefully, as the
reference's: a rule whose mesh axes are absent, already taken, or do
not divide the dimension falls back to replication, so the same model
code runs on a world of one and on the 512-rank production mesh.

  * ``pspec(dims, shape, rules, mesh)``  -> PartitionSpec
  * ``logical_sharding(dims, shape, mesh)`` -> NamedSharding, whose
    ``placements`` are DTensor's (``Shard(d)`` / ``Replicate()``);
    ``tree_shardings`` maps it over a spec tree and a tensor tree
  * ``shard(x, *dims)``  -> ``x`` laid out on those placements under the
    ambient mesh (``set_mesh``); the identity outside any mesh
  * ``sweep_mesh(n)`` -> the 1-D run-axis mesh of ``Sweep.run(mesh=)``
  * the port's own layout helpers for the sharded models, each the
    identity (or the plain call) outside a mesh: ``pin`` (a layout where
    the reference has no constraint), ``on_shards`` / ``rowwise`` /
    ``elementwise`` (ops run on local shards, ``local_map``), ``zeros``
    (a tensor made shard by shard), ``grad_as_output`` (a gradient laid
    out as its forward value)

Where torch differs from JAX: torch's SPMD runs one process a rank, and
a ``DeviceMesh`` spans ranks of the default process group, where the
reference's single controller lays one process's local devices out.  So
``sweep_mesh`` takes the first ``n`` ranks of the world (starting a
world of one over gloo when there is no process group yet), and every
rank calls it: building a mesh is collective.  ``set_mesh`` stands in
for ``jax.set_mesh`` (the one shim of the reference's ``_compat`` with a
torch counterpart).
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import NamedTuple

import torch
import torch.distributed as dist

# logical axis -> ordered mesh axes it may shard over.  Batch-like axes
# span pod x data (DP across the DCN and inside the pod); weight fan-in
# shards over data (FSDP); heads/ffn/vocab/experts shard over model (TP).
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "cache_batch": ("pod", "data"),
    # the Sweep engine's run axis (independent (config, scenario)
    # points): batch-like, spans DP axes
    "run": ("pod", "data"),
    "fsdp": ("data",),
    "vocab": ("model",),
    "embed": (),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "act_heads": ("model",),
    "act_embed": (),
    "experts": ("model",),
    "seq": (),
    "kv_seq": (),
    "state": (),
    "conv": (),
}


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of names sharding the dim jointly, major to minor (the
    reference's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and ``shape``)."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no mesh_dim_names: logical sharding "
                         "maps onto named mesh dims")
    return dict(zip(names, tuple(mesh.shape)))


def pspec(dims, shape, rules, mesh) -> PartitionSpec:
    """PartitionSpec for logical ``dims`` of a tensor of ``shape``.

    Each entry of ``dims`` is a logical axis name or None.  A logical
    axis shards over the subset of its rule's mesh axes that exist in
    ``mesh`` and are not already used by an earlier dim — but only when
    their combined size divides the dimension; otherwise the dim is
    replicated (None).
    """
    sizes = _mesh_sizes(mesh)
    used: set[str] = set()
    out = []
    for name, dim in zip(dims, shape):
        axes = tuple(a for a in rules.get(name or "", ())
                     if a in sizes and a not in used)
        total = math.prod(sizes[a] for a in axes) if axes else 1
        if not axes or total == 1 or dim % total != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return PartitionSpec(*out)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding(NamedTuple):
    """A ``PartitionSpec`` on a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh dim: ``Shard(d)`` where tensor
        dim ``d`` takes that mesh axis, else ``Replicate()``.  DTensor
        splits a dim sharded over several mesh dims in mesh-dim order,
        so a joint entry must list its axes in that order (the default
        rules do)."""
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(_mesh_sizes(self.mesh))
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec):
            axes = _axes(entry)
            where = [names.index(a) for a in axes]
            if where != sorted(where):
                raise ValueError(
                    f"axes {axes} of dim {d} are not in the mesh's order "
                    f"{names}: DTensor shards a dim over mesh dims in "
                    f"that order")
            for i in where:
                out[i] = Shard(d)
        return tuple(out)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of one rank's shard of a tensor of ``shape``."""
        sizes = _mesh_sizes(self.mesh)
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            ways = math.prod(sizes[a] for a in _axes(entry))
            if n % ways:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"{ways} ways")
            out.append(n // ways)
        return tuple(out)


def logical_sharding(dims, shape, mesh) -> NamedSharding:
    """NamedSharding for ``dims`` under DEFAULT_RULES."""
    return NamedSharding(mesh, pspec(dims, shape, DEFAULT_RULES, mesh))


def tree_shardings(specs, tree, mesh):
    """``logical_sharding`` of each dims leaf of ``specs`` (a tree of
    dims tuples, as ``param_specs`` or ``train_state_specs`` give it) at
    the shape of the tensor at its place in ``tree``, a tree of the same
    structure (dicts, lists, NamedTuples); None stays None.  What
    ``load_checkpoint(shardings=)`` and ``train_loop(state_shardings=)``
    take."""
    if specs is None or tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return logical_sharding(specs, tuple(tree.shape), mesh)
    if isinstance(tree, dict):
        return {k: tree_shardings(specs[k], v, mesh) for k, v in tree.items()}
    out = [tree_shardings(s, t, mesh) for s, t in zip(specs, tree)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


_AMBIENT = threading.local()


@contextlib.contextmanager
def set_mesh(mesh):
    """``with set_mesh(mesh):`` makes ``mesh`` the calling thread's
    ambient mesh (``jax.set_mesh``'s scoping); scopes nest, and
    ``set_mesh(None)`` hides an outer one.  Inside, a plain tensor meets
    a DTensor as a replicated one (DTensor's ``implicit_replication``,
    a process-wide switch while any scope is open): model code makes
    its positions, masks and constants as plain tensors, the same on
    every rank, as the reference's SPMD program does."""
    stack = _AMBIENT.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        if mesh is None:
            yield mesh
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield mesh
    finally:
        stack.pop()


def ambient_mesh():
    """The innermost ``set_mesh`` of the calling thread, or None."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def shard(x, *dims):
    """Lay ``x`` out by logical dims under the ambient mesh.

    Inside a ``with set_mesh(mesh):`` scope a DTensor is redistributed to
    ``logical_sharding(dims, x.shape, mesh)``'s placements and a plain
    tensor is distributed onto them; with no mesh (unit tests, one
    device) it is the identity, so model code can call it
    unconditionally.
    """
    mesh = ambient_mesh()
    if mesh is None:
        return x
    return _to(x, mesh, logical_sharding(dims, tuple(x.shape),
                                         mesh).placements)


def _to(x, mesh, placements):
    """``x`` on ``placements``: a DTensor redistributed, a plain tensor
    (the same on every rank, as SPMD code makes it) cut locally, with no
    collective (``src_data_rank=None``).  The local shard is made
    contiguous: a shard cut from a replica is a strided view, which the
    views inside later ops (a product's flattening) cannot take."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        y = x.redistribute(mesh, placements)
    else:
        y = distribute_tensor(x, mesh, placements, src_data_rank=None)
    if not y._local_tensor.is_contiguous():
        y = DTensor.from_local(y.to_local().contiguous(), mesh,
                               y.placements, run_check=False,
                               shape=y.shape, stride=y.stride())
    return y


def _view_placements(placements, src_shape, dst_shape) -> tuple:
    """DTensor placements of a tensor of ``src_shape`` that gives
    ``placements`` once viewed as ``dst_shape``: each run of dims the
    view splits or merges maps onto its first dim (a shard of a later
    dim in the run has no such layout and raises)."""
    from torch.distributed.tensor import Replicate, Shard
    groups, i, j = {}, 0, 0
    while i < len(src_shape) or j < len(dst_shape):
        si, dj = [i], [j]
        a = src_shape[i] if i < len(src_shape) else 1
        c = dst_shape[j] if j < len(dst_shape) else 1
        while a != c:
            if a < c:
                i += 1
                si.append(i)
                a *= src_shape[i]
            else:
                j += 1
                dj.append(j)
                c *= dst_shape[j]
        for k, d in enumerate(dj):
            groups[d] = si[0] if k == 0 else None
        i, j = i + 1, j + 1
    out = []
    for p in placements:
        if isinstance(p, Shard):
            src = groups.get(p.dim)
            if src is None:
                raise ValueError(f"no layout of {tuple(src_shape)} views as "
                                 f"{tuple(dst_shape)} sharded on dim {p.dim}")
            p = Shard(src)
        out.append(p if isinstance(p, Shard) else Replicate())
    return tuple(out)


def pin(x, *dims, shape=None):
    """Lay ``x`` out by logical dims under the ambient mesh, where the
    reference has no constraint: the port's own pins (the identity
    outside a mesh, as ``shard``).  DTensor picks each op's layout
    greedily, and may split a dim that a later view cannot unflatten
    (40 heads on a 16-way axis) or give an op a layout it has no rule
    for; a pin fixes the layout first, and, being a redistribute, fixes
    the gradient's layout on its way back too.  ``shape``, when given, is
    the shape ``x`` is viewed as next to the pin (split or merged dims):
    ``dims`` name that shape's dims, and ``x`` takes the layout that
    views as theirs."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    if shape is None:
        placements = logical_sharding(dims, tuple(x.shape), mesh).placements
    else:
        placements = _view_placements(
            logical_sharding(dims, tuple(shape), mesh).placements,
            tuple(x.shape), tuple(shape))
    return _to(x, mesh, placements)


def zeros(shape, dims, dtype, device):
    """``torch.zeros(shape)`` laid out by logical ``dims`` under the
    ambient mesh, each rank making only its own shard (the caches and
    states a model allocates); outside a mesh, ``torch.zeros``."""
    mesh = ambient_mesh()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    sh = logical_sharding(dims, shape, mesh)
    local = torch.zeros(sh.shard_shape(shape), dtype=dtype, device=device)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, sh.placements, run_check=False,
                              shape=shape, stride=stride)


def on_shards(fn, args, placements, out_placements):
    """``fn(*args)`` on each rank's local shards (``local_map``): the
    args brought to ``placements`` (one tuple an arg; a plain tensor is
    cut locally), the outputs DTensors on ``out_placements`` (a list of
    placements for one output, a tuple of such lists for several).  For ops
    that are the same math shard by shard and that DTensor has no rule
    for, or would lay out on its own in a way the next op cannot take.
    Outside a mesh, ``fn(*args)``."""
    mesh = ambient_mesh()
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    args = [_to(a, mesh, p) for a, p in zip(args, placements)]

    def local(*a):
        out = fn(*a)
        if isinstance(out, torch.Tensor):
            return out.contiguous()
        return tuple(o.contiguous() for o in out)
    return local_map(local, out_placements=out_placements,
                     in_placements=tuple(placements),
                     device_mesh=mesh)(*args)


def placements_of(x, *, free=()) -> list:
    """``x``'s placements (all ``Replicate()`` for a plain tensor) under
    the ambient mesh, with a shard of any tensor dim in ``free`` (dims an
    op runs along) turned into ``Replicate()``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = ambient_mesh()
    if not isinstance(x, DTensor):
        return [Replicate() for _ in range(mesh.ndim)]
    return [Replicate() if isinstance(p, Shard) and p.dim in free else p
            for p in x.placements]


def rowwise(fn, args, n_out: int = 1):
    """``fn(*args)`` on each rank's batch rows (axis 0 of every arg and
    output, laid out by the "batch" rule): for ops that run row by row
    (sorts, searches, cumulative sums, gathers and scatters within a
    row) and that DTensor has no rule for.  Outside a mesh,
    ``fn(*args)``."""
    mesh = ambient_mesh()
    if mesh is None:
        return fn(*args)
    pl = [logical_sharding(("batch",) + (None,) * (a.dim() - 1),
                           tuple(a.shape), mesh).placements for a in args]
    out = list(pl[0])
    return on_shards(fn, args, pl,
                     out if n_out == 1 else tuple([out] * n_out))


def elementwise(fn, x):
    """``fn(x)`` shard by shard, ``x``'s layout kept: for elementwise
    ops that DTensor has no rule for.  Outside a mesh, ``fn(x)``."""
    mesh = ambient_mesh()
    if mesh is None:
        return fn(x)
    pl = placements_of(x)
    return on_shards(fn, (x,), (pl,), pl)


class _GradAsOutput(torch.autograd.Function):
    """Identity forward; backward lays the gradient out as the forward
    output was laid out (a ``Partial()`` as ``Replicate()``)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Partial, Replicate
        ctx.mesh = y.device_mesh
        ctx.placements = tuple(Replicate() if isinstance(p, Partial) else p
                               for p in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_as_output(y):
    """``y``, whose gradient takes ``y``'s own layout on its way back:
    DTensor lays a gradient out by the ops after ``y``, and a product's
    backward may be handed one it has no rule for (a strided shard of
    batch x time).  No collective in the forward.  Outside a mesh, or on
    a plain tensor, or without autograd, ``y`` itself."""
    from torch.distributed.tensor import DTensor
    if (ambient_mesh() is None or not isinstance(y, DTensor)
            or not (torch.is_grad_enabled() and y.requires_grad)):
        return y
    return _GradAsOutput.apply(y)


def _world_of_one() -> None:
    """Start a one-rank gloo process group (no socket: an in-process
    store), as ``procs.init_processes`` would for a single process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)


def sweep_mesh(n_devices: int | None = None, axis: str = "run"):
    """1-axis ``DeviceMesh`` for ``Sweep.run(mesh=...)``.

    Spans the first ``n_devices`` ranks of the default process group
    (all by default) on one axis named ``axis``; with no process group
    it starts a world of one.  The mesh is on ``cuda`` when a card is
    present, else on the ``cpu``; a cuda mesh puts rank r on
    ``cuda:(LOCAL_RANK or r) % device_count``, so several ranks may
    share one card.  Every rank of the world calls it (building a mesh
    is collective); a rank past ``n_devices`` gets a mesh it is not in.
    The Sweep engine shards its run batch over every axis of whatever
    mesh it is given, so any named ``DeviceMesh`` works: this is the
    common single-axis spelling.
    """
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n} outside 1..{world}")
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if not dist.is_initialized():
        _world_of_one()
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(axis,))
