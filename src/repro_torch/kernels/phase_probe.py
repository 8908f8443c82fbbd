"""Where a megakernel step's time goes, phase by phase, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.phase_probe [--cell dc]

``torch.profiler`` sees a ``megastep_block`` launch as one opaque
event, so this probe builds a stamped copy of ``csrc/fluid_step.cu`` on
the side (under ``_build/phase_probe/``, with the port's nvcc flags):
thread 0 of the first CTA reads ``%globaltimer`` at the top of every
step and after every barrier of the step loop (``__syncthreads()`` or
the run's barrier).  It then runs one ``megastep_block`` window of
``--steps`` steps of the cell with the stamped library swapped in for
the wrapper's own, and prints one JSON line: the median microseconds of
a step and of each interval between stamps, each labelled with the
source line of the barrier that ends it and the phase comment
(``// ---- ...``) above it.  Medians over the window's steps; an
interval holds whatever the stamping CTA waited for at that barrier
(other warps, or with a cluster the slowest CTA).  The stamps cost a
global store each; the window's CUDA-event time is printed beside them.

Cells: ``dc`` (the 36 CC stage combinations x a 4096-flow permutation
on ``dragonfly(4, 4, 4)``, chip_smoke's DC cell) and ``paper`` (the
paper's incast grid).  ``--cluster c`` runs the cell at c CTAs a run in
place of the plan's own choice (still held to what stays resident).
Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

STAMP_DEFS = r'''
__device__ unsigned long long g_phase_stamps[256 * 64];
#define PHASE_STAMP(k) do { if (blockIdx.x == 0 && threadIdx.x == 0 && \
    step < 256) { unsigned long long tt; \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tt)); \
    g_phase_stamps[step * 64 + (k)] = tt; } } while (0)
extern "C" int phase_probe_read(void* host, long long n) {
  return (int)cudaMemcpyFromSymbol(host, g_phase_stamps, n * 8);
}
'''
LOOP = "for (long long step = 0; step < a.n_substeps; ++step) {"
BARRIERS = ("__syncthreads();", "cluster_sync();", "run_sync(c);")


def stamp_source(src: str) -> tuple[str, list[dict]]:
    """The source with a stamp at the top of the step loop (stamp 0) and
    after each barrier inside it; returns it and the stamps' labels."""
    lines = src.split("\n")
    out, labels = [], []
    depth, inside, phase = 0, False, ""
    for i, line in enumerate(lines, 1):
        out.append(line)
        st = line.strip()
        if not inside and st.startswith(LOOP):
            inside, depth = True, 1
            out.append("    PHASE_STAMP(0);")
            continue
        if not inside:
            continue
        depth += line.count("{") - line.count("}")
        if depth <= 0:
            inside = False
            continue
        if st.startswith("// ----"):
            phase = st.strip("/- ").strip()
        if st in BARRIERS:
            labels.append({"line": i, "barrier": st.split("(")[0],
                           "phase": phase})
            out.append(f"    PHASE_STAMP({len(labels)});")
    if len(labels) >= 63:
        raise ValueError(f"{len(labels)} barriers in the step loop; the "
                         f"probe holds 63")
    text = "\n".join(out)
    text = text.replace('#include "cc_device.cuh"',
                        '#include "cc_device.cuh"\n' + STAMP_DEFS, 1)
    return text, labels


def build_stamped() -> tuple[ctypes.CDLL, list[dict]]:
    from . import build
    from . import fluid_step as FS
    with open(os.path.join(build.CSRC, "fluid_step.cu")) as f:
        text, labels = stamp_source(f.read())
    out_dir = os.path.join(build.BUILD_DIR, "phase_probe")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "fluid_step_stamped.cu")
    so = os.path.join(out_dir, "libfluid_step_stamped.so")
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                           build.CSRC, "-o", so, cu], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the stamped source:\n"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(so)
    for sym, (argtypes, restype) in FS._SIGNATURES.items():
        getattr(lib, sym).argtypes = argtypes
        getattr(lib, sym).restype = restype
    lib.phase_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.phase_probe_read.restype = ctypes.c_int
    return lib, labels


def cell_sweep(cell: str):
    from ..core import (CCScheme, CCSpec, PAPER_CONFIG, ScenarioSpec, Sweep,
                        cc)
    from ..net import FabricSpec
    if cell == "dc":
        spec = ScenarioSpec.permutation(4096, seed=0,
                                        fabric=FabricSpec.dragonfly(4, 4, 4))
        cfgs = {f"{m}+{n}+{r}": CCSpec(marking=m, notification=n,
                                        reaction=r)
                for m in cc.MARKING.names() for n in cc.NOTIFICATION.names()
                for r in cc.REACTION.names()}
        return Sweep.grid(configs=cfgs, scenarios={"dfly272_f4096": spec})
    if cell == "paper":
        scen = {}
        for roll in (0, 1):
            scen[f"window{roll}"] = ScenarioSpec.paper_incast(roll=roll)
            scen[f"volume{roll}"] = ScenarioSpec.paper_incast_volume(
                roll=roll)
        return Sweep.grid(configs={s.name: PAPER_CONFIG.replace(scheme=s)
                                   for s in CCScheme}, scenarios=scen)
    raise ValueError(f"unknown cell {cell!r} (dc, paper)")


def probe(cell: str = "dc", steps: int = 100,
          cluster: int | None = None) -> dict:
    import numpy as np
    import torch
    from . import fluid_step as FS
    if not 2 <= steps <= 256:
        raise ValueError("steps must be in 2..256")
    dev = torch.device("cuda", torch.cuda.current_device())
    lib, labels = build_stamped()
    own, own_size = FS._lib, getattr(FS, "cluster_size", None)
    FS._lib = lambda: lib
    if cluster is not None:
        if own_size is None:
            raise ValueError("--cluster: this tree's megakernel has no "
                             "clusters")
        FS.cluster_size = lambda R, F, n_sm=None: cluster
    try:
        sweep = cell_sweep(cell)
        stg = sweep.prepare(steps, trace_every=steps, device=dev,
                            use_kernels="mega")
        st = stg.block(stg.state)[0]
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        stg.block(st)
        b.record()
        torch.cuda.synchronize()
        buf = np.zeros(256 * 64, np.uint64)
        err = lib.phase_probe_read(buf.ctypes.data, buf.size)
        if err:
            raise RuntimeError(f"reading the stamps failed ({err})")
    finally:
        FS._lib = own
        if own_size is not None:
            FS.cluster_size = own_size
    s = buf.reshape(256, 64)[:steps].astype(np.int64)
    k = np.array([0] + [i + 1 for i in range(len(labels))])
    hit = (s[:, k] > 0).all(axis=0)          # barriers this cell reaches
    k = k[hit]
    phases = []
    for prev, cur in zip(k, k[1:]):
        lab = labels[cur - 1]
        phases.append({**lab, "us": float(np.median(s[:, cur] - s[:, prev]))
                       / 1e3})
    geo = getattr(FS, "GEOMETRY", {}).get("megastep_block")
    return {"cell": cell, "runs": len(sweep.points), "steps": steps,
            "device": torch.cuda.get_device_name(dev),
            "window_ms_cuda_events": a.elapsed_time(b),
            "step_us_median": float(np.median(np.diff(s[:, 0]))) / 1e3,
            "geometry": geo._asdict() if geo is not None else None,
            "phases": phases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="dc", choices=("dc", "paper"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cluster", type=int, default=None)
    args = ap.parse_args(argv)
    print(json.dumps(probe(args.cell, args.steps, args.cluster)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
