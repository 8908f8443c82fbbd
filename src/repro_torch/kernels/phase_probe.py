"""Where a megakernel step's time goes, phase by phase, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.phase_probe \\
        [--cell dfly72_permutation] [--steps 100] [--cluster c]

``torch.profiler`` sees a ``megastep_block`` launch as one opaque
event, so this probe turns on the kernel's own phase timers
(``fluid_step.phase_timers``: the launch runs the kernel's timed
instance, whose thread 0 of the first CTA adds the ``clock64()`` cycles
between the marks of the step loop, one at the top of every step and
one after every barrier) for one window of ``--steps`` steps of the
cell, and prints one JSON line: the window's CUDA-event time, the loop's
``%globaltimer`` time, and per mark the cycles and microseconds a step
of the interval that ends there, labelled with the barrier and the
phase comment (``// ---- ...``) above it (``fluid_step.PHASES``).
Microseconds convert cycles at the loop's own rate (its nanoseconds over
its cycles).  An interval holds whatever the timing CTA waited for at
its barrier (other warps, or with a cluster the slowest CTA); the marks
cost one thread a few global reads and writes each.

Cells: ``dfly72_permutation`` and ``dfly72_hotspot``, the benchmark's
fabric (``dragonfly(4, 2, 2)``, 72 hosts) under the 36 CC stage
combinations with ``permutation(4096)`` or ``hotspot(4096,
hot_frac=0.5)``, and ``paper`` (the paper's incast grid).  ``--cluster
c`` runs the cell at c CTAs a run in place of the plan's own choice.
Needs a card.
"""

from __future__ import annotations

import argparse
import json

CELLS = ("dfly72_permutation", "dfly72_hotspot", "paper")


def cell_sweep(cell: str):
    from ..core import (CCScheme, CCSpec, PAPER_CONFIG, ScenarioSpec, Sweep,
                        cc, workloads)
    from ..net import FabricSpec
    if cell == "paper":
        scen = {}
        for roll in (0, 1):
            scen[f"window{roll}"] = ScenarioSpec.paper_incast(roll=roll)
            scen[f"volume{roll}"] = ScenarioSpec.paper_incast_volume(
                roll=roll)
        return Sweep.grid(configs={s.name: PAPER_CONFIG.replace(scheme=s)
                                   for s in CCScheme}, scenarios=scen)
    if cell not in CELLS:
        raise ValueError(f"unknown cell {cell!r} ({', '.join(CELLS)})")
    fab = FabricSpec.dragonfly(4, 2, 2, groups=9)
    if cell == "dfly72_permutation":
        spec = ScenarioSpec.permutation(4096, seed=0, fabric=fab)
    else:
        wl = workloads.hotspot(4096, 72, hot_frac=0.5, t_start=20e-6, seed=0)
        spec = ScenarioSpec.from_workload(wl, fabric=fab)
    cfgs = {f"{m}+{n}+{r}": CCSpec(marking=m, notification=n, reaction=r)
            for m in cc.MARKING.names() for n in cc.NOTIFICATION.names()
            for r in cc.REACTION.names()}
    return Sweep.grid(configs=cfgs, scenarios={cell: spec})


def probe(cell: str = "dfly72_permutation", steps: int = 100,
          cluster: int | None = None) -> dict:
    import torch
    from . import fluid_step as FS
    if steps < 2:
        raise ValueError("steps must be at least 2")
    dev = torch.device("cuda", torch.cuda.current_device())
    own = FS.cluster_size
    if cluster is not None:
        FS.cluster_size = lambda R, F, n_sm=None: cluster
    try:
        sweep = cell_sweep(cell)
        stg = sweep.prepare(steps, trace_every=steps, device=dev,
                            use_kernels="mega")
    finally:
        FS.cluster_size = own
    st = stg.block(stg.state)[0]          # warm: builds and loads the kernel
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with FS.phase_timers() as t:
        a.record()
        stg.block(st)
        b.record()
    ns_per_cycle = t["loop_ns"] / max(t["loop_cycles"], 1)
    phases = [dict(p, cycles_a_step=p["cycles"] / steps,
                   us_a_step=p["cycles"] * ns_per_cycle / steps / 1e3,
                   share=100.0 * p["cycles"] / max(t["loop_cycles"], 1))
              for p in t["phases"] if p["n"]]
    geo = FS.GEOMETRY.get("megastep_block")
    return {"cell": cell, "runs": len(sweep.points), "steps": steps,
            "device": torch.cuda.get_device_name(dev),
            "window_ms_cuda_events": a.elapsed_time(b),
            "loop_ms": t["loop_ns"] / 1e6, "loop_cycles": t["loop_cycles"],
            "step_us": t["loop_ns"] / steps / 1e3,
            "geometry": geo._asdict() if geo is not None else None,
            "phases": phases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default=CELLS[0], choices=CELLS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cluster", type=int, default=None)
    args = ap.parse_args(argv)
    print(json.dumps(probe(args.cell, args.steps, args.cluster)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
