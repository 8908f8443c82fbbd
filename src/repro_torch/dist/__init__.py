"""repro_torch.dist — the distribution substrate of the port (port of
``repro.dist``, the parts with a meaning on one card).

Public surface:
  * procs: init_processes / process_info (``torch.distributed`` process
    bootstrap for the fleet's distributed backend)
  * pacer: chunk_bytes_of / erp_chunk_schedule

Not ported: the reference's ``sharding`` (jax mesh rules and the run-axis
``sweep_mesh``), ``pipeline`` (pipeline parallelism over a jax mesh) and
``_compat`` (jax API shims) — on one card there is no mesh to shard
across (ROADMAP.md records them).
"""

from . import pacer, procs
from .pacer import chunk_bytes_of, erp_chunk_schedule
from .procs import init_processes, process_info

__all__ = ["chunk_bytes_of", "erp_chunk_schedule", "init_processes",
           "pacer", "process_info", "procs"]
