"""repro_torch.fleet — the sweep fabric of the port (port of
``repro.fleet``).

Decomposes a parameter ``Sweep`` into content-addressed, signature-
bucketed shards (:mod:`~repro_torch.fleet.plan`), schedules them over a
work-stealing backend — threads sharing the card, or
``torch.distributed`` processes (:mod:`~repro_torch.fleet.scheduler`) —
streams each shard's traces device→host through a ring of host buffers
(:mod:`~repro_torch.fleet.stream`), and journals completions through
``repro_torch.ckpt`` so a preempted fleet resumes with zero recompute
(:mod:`~repro_torch.fleet.resume`).  The merged result is bitwise
identical to the uninterrupted ``Sweep.run()`` on the same device.

Quickstart::

    from repro_torch.fleet import FleetConfig, run_fleet
    out = run_fleet(sweep, n_steps=2000, trace_every=100,
                    config=FleetConfig(n_workers=2),
                    journal="fleet_journal")          # on the card
    out = run_fleet(sweep, n_steps=2000, device="cpu")  # on the CPU
    res = out.result            # a plain SweepResult
"""

from .plan import (FleetPlan, ShardBucket, ShardSpec, estimate_point_cost,
                   fluid_step_bytes, plan_sweep, point_digest)
from .resume import FleetJournal
from .scheduler import (Abandoned, Backend, DistributedBackend, Done,
                        FleetConfig, FleetError, FleetResult, FleetRunner,
                        FleetStats, PreemptedError, Retried, ThreadBackend,
                        WorkerLost, run_fleet)
from .stream import stream_sweep

__all__ = [
    "Abandoned", "Backend", "DistributedBackend", "Done", "FleetConfig",
    "FleetError", "FleetJournal", "FleetPlan", "FleetResult",
    "FleetRunner", "FleetStats", "PreemptedError", "Retried",
    "ShardBucket", "ShardSpec", "ThreadBackend", "WorkerLost",
    "estimate_point_cost", "fluid_step_bytes", "plan_sweep",
    "point_digest", "run_fleet", "stream_sweep",
]
