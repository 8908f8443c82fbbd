"""repro_torch.dist — the distribution substrate of the port (port of
``repro.dist``): sharding rules, the ERP-paced collective scheduler,
pipeline parallelism, and the process bootstrap.

Public surface:
  * sharding: shard / logical_sharding / pspec / DEFAULT_RULES /
    sweep_mesh (run-axis mesh for sharded Sweeps) over a torch
    ``DeviceMesh``, with DTensor placements; set_mesh (the ambient mesh,
    for ``jax.set_mesh`` of the reference's ``_compat``)
  * pacer:    chunk_bytes_of / erp_chunk_schedule
  * pipeline: pipeline_apply
  * procs:    init_processes / process_info (``torch.distributed``
    process bootstrap for the fleet's distributed backend)

The reference's ``_compat`` other shims (the shape of
``Compiled.cost_analysis``, the argument order of ``AbstractMesh``) fix
jax API drift and have no torch counterpart.
"""

from . import pacer, pipeline, procs, sharding
from .pacer import chunk_bytes_of, erp_chunk_schedule
from .procs import init_processes, process_info
from .sharding import (DEFAULT_RULES, logical_sharding, pspec, set_mesh,
                       shard, sweep_mesh)

__all__ = ["DEFAULT_RULES", "logical_sharding", "pspec", "shard",
           "sweep_mesh", "chunk_bytes_of", "erp_chunk_schedule",
           "init_processes", "pacer", "pipeline", "process_info", "procs",
           "set_mesh", "sharding"]
