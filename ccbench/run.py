"""Run one cell of the benchmark once and print its result line.

    python3 ccbench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

Set-up builds the cell's grid from the seed (``harness.cell``), makes it
the program's ``Sweep`` (``harness.program``) and runs two full sweeps of
the cell's shapes: the first builds the kernels and captures the window.  The
measured window is a closed loop of one researcher: each sweep of the
grid, at the next point of the mix's parameter axis, starts when the last
one's ``SweepResult`` is on the host.  With ``--trace 1`` one more sweep
runs traced (``harness.trace``) and the cell's per-layer metrics are
read from it (``metrics/<name>.py``).  Then a sweep of the window drawn
from the seed is checked against the plain reference (``harness.check``)
on runs drawn from the seed.  The last line of standard output is the
result as JSON; the compared numbers and their limits end standard
error.
"""

import time

T0 = time.perf_counter()

import argparse                                          # noqa: E402
import importlib.util                                    # noqa: E402
import json                                              # noqa: E402
import os                                                # noqa: E402
import statistics                                        # noqa: E402
import sys                                               # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

#: top-level module names the benchmarked process may not hold: JAX, and
#: the JAX package the port was made from (``repro``, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def benchmark_entry(name: str) -> tuple[dict, list, list]:
    """(the cell's ``workloads`` entry, its end-to-end and per-layer
    metric entries) from ``BENCHMARK.json``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return cells[name], mine(bench["end_to_end"]), mine(bench["per_layer"])


def reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "ccbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device):
    import torch
    if torch.device(device or "cuda").type == "cuda":
        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device=None, overrides=None, e2e=(), per_layer=()) -> dict:
    """One run of the cell; returns the result line's fields and the
    compared numbers (``device=None``: the card)."""
    import numpy as np
    import torch
    from ccbench.harness import cell as cell_mod
    from ccbench.harness import check, program
    from repro_torch.core import SWEEP_EXEC_CACHE

    on_card = device is None
    cell = cell_mod.load(name, seed, overrides)
    grid = program.Grid(cell)
    kw = grid.run_kw(device)
    # warm-up: the first sweep builds the kernels and captures the window;
    # the second runs while the first's result is still held, as every
    # sweep of the window runs beside the sampled result it may keep
    # (without it the window's second sweep ran 4-55% slower)
    held = grid.sweep(1.0).run(**kw)
    grid.sweep(cell.scale(len(cell.axis_order) - 1)).run(**kw)
    del held
    _sync(device)

    rng = np.random.default_rng([cell.seed, 4])
    lat, kept = [], None
    cache0 = SWEEP_EXEC_CACHE.stats()
    setup_s = time.perf_counter() - T0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = len(lat)
        t = time.perf_counter()
        res = grid.sweep(cell.scale(i)).run(**kw)
        lat.append(time.perf_counter() - t)
        if rng.random() * (i + 1) < 1.0:       # a uniform sample, kept
            kept = (i, res)
        del res
    window_s = time.perf_counter() - t0
    n = len(lat)
    values = {
        "run_steps_per_s": n * cell.runs * cell.steps / window_s,
        "sweep_p90_ms": statistics.quantiles(
            [x * 1e3 for x in lat], n=10, method="inclusive")[8]
        if n >= 2 else lat[0] * 1e3,
        "setup_s": setup_s,
    }
    out = {"attempted": n, "failed": 0, "setup_s": setup_s,
           "window_s": window_s, "sweep_ms": [x * 1e3 for x in lat]}
    dev_rec = {"platform": "gpu" if on_card else "cpu",
               "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
               "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
               if on_card else 0}
    if trace:
        rec = trace_readings(cell, grid, kw, cache0, device)
        rec["sweep_ms"] = out["sweep_ms"]
        metrics = {}
        for m in per_layer:
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_rec.update(busy_s=rec["busy_s"], window_s=rec["wall_s"])
        out["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in rec["kernel_s"].items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": rec["idle_gaps"]}
        out["attempted"] += 1
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}

    # the check: the program's state freed first, the reference after
    i, res = kept
    SWEEP_EXEC_CACHE.clear()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    runs = check.pick_runs(cell, cell.mix["check"]["runs"], cell.seed)
    t = time.perf_counter()
    ref = check.reference_result(cell, runs, cell.scale(i),
                                 device="cuda" if on_card else "cpu")
    ends = {roll: grid.link_ends(roll) for roll in cell.fabrics}
    compared = check.compare(check.program_view(res, runs, ends, cell),
                             check.reference_view(ref, runs, cell))
    out.update(correct=check.verdict(compared), metrics=metrics,
               device=dev_rec, checked={"sweep": i, "runs": runs,
                                        "reference_s": time.perf_counter() - t})
    out["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                     for k, v in compared.items()}
    return out


def trace_readings(cell, grid, kw, cache0, device) -> dict:
    """The per-layer record: spans and counters of the run so far, then
    one traced sweep."""
    from ccbench.harness import trace as trace_mod
    from repro_torch.core import SWEEP_EXEC_CACHE
    from repro_torch.kernels import cc_step

    sweep = grid.sweep(1.0)
    _sync(device)
    t = time.perf_counter()
    stg = sweep.prepare(**kw)
    _sync(device)
    prepare_ms = (time.perf_counter() - t) * 1e3
    shapes = staged_shapes(stg)
    del stg
    tkw = dict(kw, n_steps=int(cell.mix.get("trace_steps", cell.steps)))
    cc_step.reset_launch_counts()
    rec = trace_mod.traced_sweep(sweep, tkw, on_card=device is None)
    rec.update(
        tier=cell.tier, steps=tkw["n_steps"], trace_every=cell.trace_every,
        shapes=shapes, launches=dict(cc_step.LAUNCHES),
        scenario_build_s=grid.build_s, prepare_ms=prepare_ms,
        cache=(SWEEP_EXEC_CACHE.stats() - cache0).to_dict())
    return rec


def staged_shapes(stg) -> dict:
    """What the roofline counts read of a staged batch: its sizes, the
    bytes of its state and scenario, and the incidence entries walked."""
    sd, st = stg.sd, stg.state
    R, F, K, H = sd.alt_routes.shape

    def nbytes(tree):
        n = 0
        for x in tree:
            for y in (x.values() if isinstance(x, dict) else [x]):
                n += y.numel() * y.element_size()
        return n

    scn = [getattr(sd, f) for f in (
        "gen_rate", "t_start", "t_stop", "volume", "cap_ext", "nic_buffer",
        "jitter", "sink_ext", "rtt", "alt_routes", "alt_hops", "vc",
        "red_perm", "red_off", "pool_perm")]
    return {"R": R, "F": F, "K": K, "H": H,
            "state_bytes": nbytes(st), "scenario_bytes": nbytes(scn),
            "entries": int(stg.plan.seg_off[-1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    entry, e2e, per_layer = benchmark_entry(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   e2e=e2e, per_layer=per_layer)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the port may not use JAX or the JAX "
              f"package", file=sys.stderr)
        return 3
    print(f"phases: setup {out['setup_s']:.3f} s, window "
          f"{out['window_s']:.3f} s ({out['attempted']} sweeps), reference "
          f"{out['checked']['reference_s']:.3f} s, total "
          f"{time.perf_counter() - T0:.3f} s", file=sys.stderr)
    print("sweeps ms: " + " ".join(f"{x:.1f}" for x in out["sweep_ms"]),
          file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(result_line(out))
    return 0


def result_line(out: dict) -> str:
    """The result as one JSON line: the contract's keys, then what was
    checked, and the compared numbers with their limits last."""
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checked"] = out["checked"]
    line["checks"] = out["checks"]
    return json.dumps(line)


if __name__ == "__main__":
    sys.exit(main())
