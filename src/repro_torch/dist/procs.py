"""Multi-process bootstrap for the fleet's distributed backend (port of
``repro.dist.procs``, over ``torch.distributed``).

Thin, idempotent wrappers so fleet code can ask "who am I / how many of
us are there" without caring whether the run is single-process (the
answer is then (0, 1)) or a real multi-process job.  The fleet's
processes coordinate through the journal's files, not through
collectives, so the backend is ``gloo`` on any machine: it needs no
card per process.
"""

from __future__ import annotations

import torch.distributed as dist


def init_processes(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> tuple[int, int]:
    """Join (or start) the process group; returns (rank, world size).

    Idempotent — a second call is a no-op.  With all-None arguments
    torch reads ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
    ``WORLD_SIZE`` from the environment (``env://``); explicit arguments
    (``"host:port"`` or a ``tcp://`` URL, the process count and this
    process's rank) drive a job on one machine, as the tests do.
    """
    if not dist.is_initialized():
        kw = {}
        if coordinator_address is not None:
            addr = coordinator_address
            kw["init_method"] = addr if "://" in addr else f"tcp://{addr}"
        if num_processes is not None:
            kw["world_size"] = int(num_processes)
        if process_id is not None:
            kw["rank"] = int(process_id)
        dist.init_process_group("gloo", **kw)
    return process_info()


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) when no process group is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
