"""Production meshes (port of ``repro.launch.mesh``).

``make_production_mesh`` is a FUNCTION (never a module-level constant) so
importing this module never touches process-group state.

Axes:
  * pod   — 2  (cross-pod DCN axis; ERP-paced collectives live here)
  * data  — 16 (in-pod DP/FSDP)
  * model — 16 (TP/SP/EP)

A ``DeviceMesh`` spans the ranks of the default process group, one
process a rank, so the production meshes need a world of 256 or 512
ranks: real (NCCL over that many cards) or fake (torch's ``fake``
backend, which checks layouts in one process without a card).  Without
a process group, ``make_host_mesh`` starts a world of one.  The device
type is ``"cuda"`` when a card is present, else ``"cpu"``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A mesh of ``shape`` over ``axes`` spanning the whole default
    process group, whose size must be ``prod(shape)`` (every rank calls
    it).  For elastic-scaling experiments and tests."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    need = math.prod(shape)
    if not dist.is_initialized():
        if need != 1:
            raise ValueError(
                f"a {shape} mesh needs a world of {need} ranks and no "
                f"process group is initialised: start one with "
                f"torch.distributed.init_process_group (the 'fake' "
                f"backend checks layouts without cards)")
        from ..dist.sharding import _world_of_one
        _world_of_one()
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"a {shape} mesh needs a world of {need} ranks; "
                         f"the process group has {world}")
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh():
    """Single-rank mesh with the production axis names (a world of one)."""
    return make_mesh((1, 1), ("data", "model"))


def describe(mesh) -> str:
    return " x ".join(f"{k}={v}" for k, v in
                      zip(mesh.mesh_dim_names, tuple(mesh.shape)))
