#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):
  1. device  — the card, as ``nvidia-smi`` reports it;
  2. build   — ``nvcc`` builds every CUDA source of the port, in parallel;
  3. kernels — each per-flow CC kernel against its plain PyTorch version
               on the card at the main-path shape (R=36 runs x F=4096
               flows) and at F in {1, 127, 129, 8193}: bitwise equal;
               ``segment_reduce`` likewise at the DC shape (36 x 20,480
               rows, C = 1, 2, 3) and the edge shapes; kernel / plain /
               library time and the bound;
  4. paper   — the paper's section II sweep: 3 schemes x the incast
               scene (window and equal-work, both wirings) for 14 ms at
               dt = 1 us in one ``Sweep.run``; the orderings the paper
               reports are asserted; rerun with ``use_kernels="mega"``
               and held bitwise to the first run;
  5. golden  — both golden grids of ``tests/golden`` re-run on the card
               at their tolerances (K = 4 min/valiant/UGAL paths, PFC
               pathologies), each kernel launched once a step, and a
               second run of one grid must be bitwise equal to the first;
               each grid rerun through the megakernel, bitwise equal;
  6. dc      — the main path at datacenter scale: the 36 CC stage
               combinations x a 4096-flow permutation on a 272-host
               dragonfly.  A 200-step window runs on the card and on the
               CPU (plain versions) and must agree; then 5000 steps on
               the card give steps/s and peak device memory;
  7. mega    — the dc batch through the megakernel: 200 ``megastep``
               launches held StepTrace by StepTrace to the flow tier,
               ``megastep_block`` at F in {1, 127, 129, 8193}, then the
               5000-step dc sweep as one launch per trace window, bitwise
               equal to phase 6's result, with its steps/s and profile;
  8. hotspot — half of 4096 flows into one host of the same dragonfly:
               too skewed for the dense walk, so the segment sum runs on
               the ``segment_reduce`` kernel; with ``reduce="pallas"`` and
               on the CPU it must agree bitwise;
  9. attention — ``flash_attention`` and ``decode_attention`` against
               their plain versions (3e-5 float32, 2e-2 bfloat16) at
               gemma2-27b's serving shapes and at the edge shapes of
               tests/test_kernels.py; kernel / plain / bound time, and
               ``scaled_dot_product_attention`` where it computes the same
               function (softcap 0);
 10. serve   — gemma2-27b at full width and depth in bfloat16 (random
               weights from seed 0 on the card): 8 ragged prompts of
               4100-4200 tokens on 4 slots, 16 new tokens each, through
               ``ServingEngine.generate``; exact launch counts (46 a
               prefill, 46 a decode step), time to first token, prefill
               and decode tokens/s, peak memory; then at batch 1 the
               prefill and first decode logits against the plain path;
 11. serve_f32 — gemma2-27b at full width cut to 2 layers (one local, one
               global) in float32: greedy tokens equal to the plain path;
 12. card_vs_cpu — the gemma2 smoke config serves the same prompts on the
               card and on the CPU: equal tokens; the serving launcher's
               ``--smoke`` run on the card.
Kernel launch counts are zeroed just before each path's run and read
just after; every path asserts each of its kernels' exact count.
Then the ``kernels`` summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.

Needs one CUDA card; without one (or without the rest of the repo next
to this file) it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
GOLDEN = os.path.join(HERE, "tests", "golden")

#: published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

#: steps of the DC-scale run, and of its card-vs-CPU window
DC_STEPS = 5000
DC_CHECK_STEPS = 200
#: steps of the hotspot runs (card engines and the CPU window)
HOT_STEPS = 200

KERNELS = {
    # name: (TPU kernel it replaces, float32 ops per flow)
    "gen_np_step": ("src/repro/kernels/cc_step.py:134", 9),
    "rp_step": ("src/repro/kernels/cc_step.py:208", 24),
    "erp_step": ("src/repro/kernels/cc_step.py:241", 9),
    "swift_step": ("src/repro/kernels/cc_step.py:272", 13),
}
#: the whole-step kernels: name -> (source, TPU kernel it replaces)
WHOLE_STEP = {
    "segment_reduce": ("src/repro_torch/csrc/fluid_reduce.cu",
                       "src/repro/kernels/fluid_reduce.py:67"),
    "megastep": ("src/repro_torch/csrc/fluid_step.cu",
                 "src/repro/kernels/fluid_step.py:232"),
    "megastep_block": ("src/repro_torch/csrc/fluid_step.cu",
                       "src/repro/kernels/fluid_step.py:243"),
}
#: float32 operations of the megakernel's step, counted from
#: csrc/fluid_step.cu: per (flow, hop) of a step (generation, transfers,
#: EWMA, PFC inputs, surplus, grants, marking) and per incidence entry
#: walked (the 3 + 3 + 2 channel adds of the link sums)
MEGA_OPS_PER_FLOW_HOP = 48
MEGA_OPS_PER_ENTRY = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _kernel_modules():
    from repro_torch.kernels import (cc_step, decode_attention,
                                     flash_attention, fluid_reduce,
                                     fluid_step)
    return (cc_step, fluid_reduce, fluid_step, flash_attention,
            decode_attention)


def reset_counts() -> None:
    for mod in _kernel_modules():
        mod.reset_launch_counts()


def counts() -> dict:
    """Launches of every kernel of the port since ``reset_counts``."""
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def _expect(launches: dict, where: str, *, cc: int = 0, seg: int = 0,
            step: int = 0, block: int = 0, flash: int = 0,
            decode: int = 0):
    """Exactly these launches: ``cc`` of each CC kernel, ``seg`` of
    segment_reduce, ``step`` megastep, ``block`` megastep_block,
    ``flash`` flash_attention and ``decode`` decode_attention."""
    want = {**{k: cc for k in KERNELS}, "segment_reduce": seg,
            "megastep": step, "megastep_block": block,
            "flash_attention": flash, "decode_attention": decode}
    assert launches == want, (where, launches, want)


def _launches_once_a_step(launches: dict, n_steps: int, where: str):
    """Each CC kernel of the flow path launched exactly once a step (the
    dense walk sums the queues: no segment_reduce, no megakernel)."""
    _expect(launches, where, cc=n_steps)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    """Build every ``csrc/*.cu`` at once (one nvcc per source)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    names = build.sources()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        libs = list(ex.map(build.build, names))
    secs = time.perf_counter() - t0
    rec = {"phase": "build", "seconds": secs, "sources": names,
           "libraries": [os.path.relpath(p, HERE) for p in libs],
           "nvcc_seconds": {n: build.BUILD_SECONDS[n] for n in names}}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _kernel_inputs(name: str, R: int, F: int, device, seed: int):
    """(wrapper call, plain call) on random state of [R, F] flows."""
    import torch
    from repro_torch.core import cc
    from repro_torch.core.fluid import step_params
    from repro_torch.core.params import CCSpec, DCQCNParams
    from repro_torch.kernels import cc_step as K
    g = torch.Generator(device=device).manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        (R, F), generator=g, device=device)
    bern = lambda p: (torch.rand((R, F), generator=g, device=device)  # noqa
                      < p).float()
    # one parameter row per run: a grid over the RP/ERP/swift constants
    cfgs = [CCSpec(dcqcn=DCQCNParams(g=1 / (64 + 32 * (r % 7)),
                                     rai=5e6 * (1 + r % 3)))
            for r in range(R)]
    par = step_params(cfgs, device=device)
    dt = torch.tensor(1e-6, dtype=torch.float32, device=device)
    rows = cc.pack_react_rows(par.react, par.line_rate, dt)
    if name == "gen_np_step":
        xs = [u(0, 4e6), u(0, 5e7), u(0, 1e6), u(0, 1e-4), u(0, 12.5e9),
              u(0, 2e-3), u(1e-3, 4e-3), u(0, 6e7), u(1e6, 4e6)]
        xs[7] = torch.where(bern(0.5) > 0, torch.inf, xs[7])
        t_sec = u(0, 3e-3)[:, 0].contiguous()
        kw = dict(t_sec=t_sec, dt=dt)
        return (lambda: K.gen_np_step(*xs, **kw),
                lambda: K.gen_np_plain(*xs, K.pack_gen_np_params(t_sec, dt)))
    if name == "rp_step":
        from repro_torch.kernels.ref import RPState
        st = RPState(u(1e6, 12.5e9), u(1e6, 12.5e9), u(0, 1), u(0, 1.2e7),
                     u(0, 6e-5), u(0, 6e-5),
                     torch.floor(u(0, 9)), torch.floor(u(0, 9)))
        cnp = bern(0.3)
        return (lambda: K.rp_step(st, cnp, packed=rows["rp"]),
                lambda: K.rp_plain(st, cnp, rows["rp"]))
    if name == "erp_step":
        xs = [u(1e6, 12.5e9), u(0, 6e-5) * bern(0.5), bern(0.3),
              u(1e6, 12.5e9), u(2.5e12, 7.5e12)]
        return (lambda: K.erp_step(*xs, packed=rows["erp"]),
                lambda: K.erp_plain(*xs, rows["erp"]))
    xs = [u(1e6, 12.5e9), u(0, 5e-5) * bern(0.5), u(0, 1e-5)]
    return (lambda: K.swift_step(*xs, packed=rows["swift"]),
            lambda: K.swift_plain(*xs, rows["swift"]))


def _time_ms(fn, n: int = 100) -> tuple[float, float]:
    """(device ms, eager ms) per call of ``fn``.

    Device time: ``n`` calls captured in one CUDA graph and replayed
    between two events, so the host's launch cost is out of the number.
    Eager time: the same calls issued one by one (what a step pays).
    """
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(5):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    graph.replay()
    torch.cuda.synchronize()
    a.record()
    for _ in range(5):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    device_ms = a.elapsed_time(b) / (5 * n)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return device_ms, a.elapsed_time(b) / n


def _event_ms(fn, n: int = 10) -> float:
    """ms per call of ``fn`` issued eagerly, between two CUDA events
    (for what a CUDA graph cannot capture: host syncs inside ``fn``)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _max_abs_err(a, b) -> float:
    import torch
    err = 0.0
    for x, y in zip(a, b):
        same = torch.equal(x, y) or bool(
            ((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
        if not same:
            d = (x.double() - y.double()).abs()
            err = max(err, float(torch.nan_to_num(d, nan=float("inf"))
                                 .max()))
    return err


def phase_kernels(device) -> dict:
    """Every kernel bitwise against its plain version; timings at the
    main-path shape.  Launches made here are not counted by phase 6."""
    import torch
    from repro_torch.kernels import cc_step as K
    out = {}
    for name, (replaces, ops) in KERNELS.items():
        errs = {}
        for (R, F) in [(36, 4096), (1, 1), (3, 127), (3, 129), (2, 8193)]:
            kern, plain = _kernel_inputs(name, R, F, device, seed=R * F)
            err = _max_abs_err(kern(), plain())
            torch.cuda.synchronize()
            errs[f"{R}x{F}"] = err
            if err != 0.0:
                raise AssertionError(
                    f"{name} differs from its plain version at "
                    f"R={R}, F={F}: max |diff| = {err}")
        kern, plain = _kernel_inputs(name, 36, 4096, device, seed=7)
        (ms, eager_ms), (plain_ms, plain_eager_ms) = (_time_ms(kern),
                                                      _time_ms(plain))
        n = 36 * 4096
        b_ms = K.BYTES_PER_FLOW[name] * n / HBM_BYTES_PER_S * 1e3
        o_ms = ops * n / FP32_FLOPS * 1e3
        out[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/cc_step.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None}
        emit({"phase": "kernels", "kernel": name, "shape": [36, 4096],
              "bitwise_equal": errs, "us": ms * 1e3,
              "plain_us": plain_ms * 1e3, "bound_us": max(b_ms, o_ms) * 1e3,
              "eager_us": eager_ms * 1e3,
              "plain_eager_us": plain_eager_ms * 1e3,
              "bytes": K.BYTES_PER_FLOW[name] * n})
    return out


def _flows_sweep(F: int):
    """F same-shaped flows on the legacy CLOS (F straddles the block
    sizes: 1, 127, 129, 8193), DCQCN and DCQCN-Rev."""
    from repro_torch.core import CCScheme, PAPER_CONFIG, ScenarioSpec, Sweep
    pairs = [(i % 16, 16 + (i * 5) % 16) for i in range(F)]
    spec = ScenarioSpec.flows(pairs, t_start=0.0, t_stop=0.5e-3,
                              label=f"flows{F}")
    return Sweep.grid(configs={s.name: PAPER_CONFIG.replace(scheme=s)
                               for s in (CCScheme.DCQCN,
                                         CCScheme.DCQCN_REV)},
                      scenarios={f"f{F}": spec})


def _seg_cases(device):
    """(tag, data, rows, offsets) of segment_reduce: the fluid step's
    walks (its CSR over the real queues) at the DC batch (C = 1, 2, 3)
    and at F in {1, 127, 129, 8193}, plus the edge shapes."""
    import torch
    from repro_torch.kernels.fluid_reduce import csr_offsets
    g = torch.Generator(device=device).manual_seed(12)
    cases = []
    for tag, sweep in [("dc", _dc_sweep())] + [
            (f"F{F}", _flows_sweep(F)) for F in (1, 127, 129, 8193)]:
        stg = sweep.prepare(1, device=device)
        plan, n = stg.plan, stg.sd.alt_routes.numel()     # R*F*K*H rows
        for C in ((1, 2, 3) if tag == "dc" else (3,)):
            data = torch.randn((n, C), generator=g, device=device)
            cases.append((f"{tag}_C{C}", data, plan.seg_rows, plan.seg_off))
    z = torch.zeros((1,), dtype=torch.int64, device=device)
    cases.append(("N0", torch.zeros((0, 2), device=device), None,
                  z.expand(6).contiguous()))
    ids = torch.tensor([3, 3, 7, 7, 7, 9], device=device)
    cases.append(("empty_segments", torch.randn((6, 2), generator=g,
                                                device=device),
                  None, csr_offsets(ids, 12)))
    cases.append(("one_segment", torch.randn((5000, 3), generator=g,
                                             device=device), None,
                  torch.tensor([0, 0, 5000, 5000], device=device)))
    return cases


def phase_segment_reduce(device) -> dict:
    """segment_reduce bitwise against its plain version at every case;
    timed (and against torch.segment_reduce) at the DC shape, C = 3."""
    import torch
    from repro_torch.kernels import fluid_reduce as FR
    errs, dc = {}, None
    for tag, data, rows, off in _seg_cases(device):
        S = off.shape[0] - 1
        got = FR.segment_reduce(data, None, S, rows=rows, offsets=off)
        want = FR.segment_reduce_plain(data, off, rows)
        torch.cuda.synchronize()
        errs[tag] = _max_abs_err([got], [want])
        if errs[tag] != 0.0:
            raise AssertionError(f"segment_reduce differs from its plain "
                                 f"version at {tag}: {errs[tag]}")
        if tag == "dc_C3":
            dc = (data, rows, off)
    data, rows, off = dc
    S, C = off.shape[0] - 1, data.shape[1]
    M = rows.shape[0]
    srt = data[rows]
    lengths = off[1:] - off[:-1]
    lib = torch.segment_reduce(srt, "sum", lengths=lengths, axis=0)
    lib_same = bool(torch.equal(
        lib, FR.segment_reduce(data, None, S, rows=rows, offsets=off)))
    ms, eager_ms = _time_ms(lambda: FR.segment_reduce(
        data, None, S, rows=rows, offsets=off))
    # the plain version reads its walk length on the host: not capturable
    plain_ms = _event_ms(lambda: FR.segment_reduce_plain(data, off, rows))
    # torch.segment_reduce syncs with the host: not capturable either
    library_ms = _event_ms(lambda: torch.segment_reduce(
        srt, "sum", lengths=lengths, axis=0))
    nbytes = 4 * M * C + 8 * M + 8 * (S + 1) + 4 * S * C
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = M * C / FP32_FLOPS * 1e3
    row = {"name": "segment_reduce", "route": "cuda",
           "source": WHOLE_STEP["segment_reduce"][0],
           "replaces": WHOLE_STEP["segment_reduce"][1], "launches": None,
           "max_abs_err": max(errs.values()), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(b_ms, o_ms),
           "bound_by": "bytes" if b_ms >= o_ms else "operations",
           "library_ms": library_ms}
    emit({"phase": "kernels", "kernel": "segment_reduce",
          "shape": [M, C, S], "bitwise_equal": errs, "us": ms * 1e3,
          "plain_us": plain_ms * 1e3, "bound_us": row["bound_ms"] * 1e3,
          "library_us": library_ms * 1e3, "eager_us": eager_ms * 1e3,
          "library_bitwise_equal": lib_same,
          "longest_segment": int(lengths.max()), "bytes": nbytes})
    return row


# ---------------------------------------------------------------------------
# where a step's time goes (torch.profiler over a short window)
# ---------------------------------------------------------------------------

# device-kernel name fragment -> wrapper; "erp_kernel" is tested before
# "rp_kernel", which it contains
_CC_KERNELS = (("gen_np_kernel", "gen_np_step"), ("erp_kernel", "erp_step"),
               ("swift_kernel", "swift_step"), ("rp_kernel", "rp_step"))


def profile_steps(sweep, device, n: int = 20, mega: bool = False) -> dict:
    """Profile ``n`` steps of ``sweep`` on the card: device busy time
    (sum of kernel durations on the one stream), the idle share of the
    wall time, kernels per step and the heaviest kernels.  The profiler
    adds host time, so the idle share is an upper bound.  ``mega``
    times three ``megastep_block`` windows of ``n`` steps instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    stg = sweep.prepare(n, trace_every=n, device=device,
                        use_kernels="mega" if mega else False)
    if mega:
        return _profile_windows(stg, n)
    st = stg.state
    for _ in range(3):
        st, _ = stg.step(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            st, _ = stg.step(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    rec = {"profiled_steps": n, "profiled_wall_ms_per_step": wall / n * 1e3}
    if not kern:
        rec["device"] = "not measured (the profiler saw no device events)"
        return rec
    per = {}
    for e in kern:
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(per.values())
    cc_us = {}
    for name, us in per.items():
        for tag, kname in _CC_KERNELS:
            if tag in name:
                cc_us[kname] = cc_us.get(kname, 0.0) + us / n
                break
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    rec.update({
        "device_busy_ms_per_step": busy_us / n / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernels_per_step": len(kern) / n,
        "cc_kernel_us_per_step": cc_us,
        "top_kernels_us_per_step": [[k[:80], v / n] for k, v in top]})
    return rec


def _profile_windows(stg, n: int, windows: int = 3) -> dict:
    """Device busy and idle share of ``windows`` back-to-back
    ``megastep_block`` launches of ``n`` steps: each launch is the only
    work on the stream, so CUDA events around it give its device time
    (torch.profiler recorded no device events for this path)."""
    import torch
    st = stg.block(stg.state)[0]
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(windows)]
    t0 = time.perf_counter()
    for a, b in ev:
        a.record()
        st = stg.block(st)[0]
        b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy_ms = sum(a.elapsed_time(b) for a, b in ev)
    steps = windows * n
    return {"profiled_steps": steps, "device_timed_by": "cuda events",
            "profiled_wall_ms_per_step": wall / steps * 1e3,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / 1e3 / wall,
            "kernels_per_step": windows / steps}


# ---------------------------------------------------------------------------
# phase 4: the paper's section II sweep
# ---------------------------------------------------------------------------

def phase_paper(device) -> dict:
    from repro_torch.core import (CCScheme, PAPER_CONFIG, ScenarioSpec,
                                  Sweep)
    scen = {}
    for roll in (0, 1):
        scen[f"window{roll}"] = ScenarioSpec.paper_incast(roll=roll)
        scen[f"volume{roll}"] = ScenarioSpec.paper_incast_volume(roll=roll)
    sweep = Sweep.grid(
        configs={s.name: PAPER_CONFIG.replace(scheme=s) for s in CCScheme},
        scenarios=scen)
    reset_counts()
    t0 = time.perf_counter()
    res = sweep.run(n_steps=14000, device=device)     # t_end = 14 ms
    wall = time.perf_counter() - t0
    launches = counts()
    mega, _ = _mega_rerun(sweep, res, 14000, None, device, "paper")
    s = res.summary()
    comp = {x.name: s[f"{x.name}/volume0"]["completion_ms"]
            for x in CCScheme}
    vic = {x.name: float(res[f"{x.name}/window0"]
                         .mean_throughput_while_active()[4] / 1e9)
           for x in CCScheme}
    vic1 = float(res["DCQCN_REV/window1"]
                 .mean_throughput_while_active()[4] / 1e9)
    agg1 = s["DCQCN_REV/window1"]["aggregate_gbps"]
    rec = {"phase": "paper", "runs": len(sweep.points), "steps": 14000,
           "wall_s": wall, "steps_per_s": 14000 / wall,
           "completion_ms_volume_roll0": comp,
           "victim_gbps_roll0": vic, "rev_victim_gbps_roll1": vic1,
           "rev_aggregate_gbps_roll1": agg1, "launches": launches,
           "mega": mega, "profile": profile_steps(sweep, device)}
    emit(rec)
    assert comp["DCQCN_REV"] < comp["PFC_ONLY"] < comp["DCQCN"], comp
    assert 4.5 < vic["DCQCN_REV"] < 7.0, vic          # ~5.7 GB/s
    assert vic1 > 11.5, vic1                            # ~line rate
    assert 23.0 < agg1 < 26.0, agg1                     # ~25 GB/s
    _launches_once_a_step(launches, 14000, "paper")
    return rec


# ---------------------------------------------------------------------------
# phase 5: golden grids
# ---------------------------------------------------------------------------

def _golden_routing():
    from repro_torch.core import CCScheme, PAPER_CONFIG, ScenarioSpec, Sweep
    from repro_torch.core.workloads import group_shift
    from repro_torch.net import FabricSpec
    dfly = FabricSpec.dragonfly(a=2, p=2, h=2)
    ft = FabricSpec.fat_tree(4, taper=2)
    scen = {"dfly_adv": group_shift(5, 4, t_stop=0.5e-3).spec(
                fabric=dfly, n_paths=4, route_seed=0, label="dfly_adv"),
            "ft_perm": ScenarioSpec.permutation(
                16, seed=2, fabric=ft, n_paths=4, route_seed=0,
                t_start=0.0, t_stop=0.5e-3, label="ft_perm")}
    cfgs = {f"{s.name}/{r}": PAPER_CONFIG.replace(scheme=s, routing=r)
            for s in CCScheme for r in ("min", "valiant", "ugal")}
    return (Sweep.grid(configs=cfgs, scenarios=scen), "routing_sweep.json",
            ("aggregate_gbps", "completion_ms", "delivered_mb",
             "peak_queue_kb"), ("marks", "cnps", "peak_nonmin_flows"))


def _golden_pathology():
    from repro_torch.core import CCSpec, Sweep
    from repro_torch.core.workloads import (credit_loop, hol_victim_incast,
                                            pause_storm)
    from repro_torch.net import FabricSpec
    clos = FabricSpec.clos3(4)
    dfly = FabricSpec.dragonfly(a=2, p=2, h=2)
    scen = {"holvictim": hol_victim_incast(4, 64).spec(fabric=clos),
            "pausestorm": pause_storm(3, 4, 64).spec(fabric=clos),
            "creditloop": credit_loop(5, 4).spec(fabric=dfly)}
    cfgs = {"PFC_ONLY": CCSpec(marking="cp", notification="np",
                               reaction="pfc"),
            "DCQCN": CCSpec(marking="cp", notification="np", reaction="rp"),
            "DCQCN_REV": CCSpec(marking="ecp", notification="enp",
                                reaction="erp")}
    return (Sweep.grid(configs=cfgs, scenarios=scen), "pfc_pathology.json",
            ("aggregate_gbps", "delivered_mb", "peak_queue_kb",
             "victim_slowdown", "pause_s"), ("marks", "cnps"))


def _check_golden(summ: dict, path: str, fkeys, ckeys) -> int:
    """Golden tolerances: floats rtol 2e-3, counters +-2% or +-2."""
    import math
    with open(path) as f:
        want = json.load(f)["summaries"]
    assert set(want) == set(summ), (sorted(want), sorted(summ))
    for name, row in summ.items():
        for k in fkeys:
            g, w = row[k], want[name][k]
            if math.isnan(w):
                assert math.isnan(g), (name, k, g)
                continue
            assert abs(g - w) <= 2e-3 * abs(w) + 1e-9, (name, k, g, w)
        for k in ckeys:
            g, w = row[k], want[name][k]
            assert abs(g - w) <= max(2, 0.02 * w), (name, k, g, w)
    return len(summ)


def _leaves(res):
    """(name, numpy array) of every trace field and final-state leaf."""
    import numpy as np
    for f in res.traces._fields:
        yield f"traces.{f}", np.asarray(getattr(res.traces, f))
    for f in res.final._fields:
        x = getattr(res.final, f)
        if isinstance(x, dict):
            for k, v in x.items():
                yield f"final.cc.{k}", np.asarray(v)
        else:
            yield f"final.{f}", np.asarray(x)


def _result_diff(a, b) -> tuple[bool, float, float]:
    """(bitwise equal, max |a-b|, max |a-b| / max|b| per field) of two
    results of one sweep."""
    import numpy as np
    same, abs_d, rel_d = True, 0.0, 0.0
    for (na, x), (nb, y) in zip(_leaves(a), _leaves(b)):
        assert na == nb and x.shape == y.shape, (na, nb, x.shape, y.shape)
        if np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            continue
        same = False
        x, y = x.astype(np.float64), y.astype(np.float64)
        m = float(np.nan_to_num(np.abs(x - y), nan=np.inf).max())
        scale = float(np.abs(y[np.isfinite(y)]).max(initial=0.0))
        abs_d = max(abs_d, m)
        rel_d = max(rel_d, m / max(scale, 1e-30))
    return same, abs_d, rel_d


def _mega_rerun(sweep, res, n_steps, trace_every, device, where) -> dict:
    """Rerun ``sweep`` through the megakernel (one ``megastep_block``
    launch per trace window) and hold it bitwise to the flow tier's
    result ``res`` of the same call."""
    reset_counts()
    t0 = time.perf_counter()
    mres = sweep.run(n_steps=n_steps, trace_every=trace_every,
                     device=device, use_kernels="mega")
    wall = time.perf_counter() - t0
    launches = counts()
    same, abs_d, _ = _result_diff(mres, res)
    rec = {"wall_s": wall, "steps_per_s": n_steps / wall,
           "bitwise_equal_flow_tier": same, "max_abs_diff": abs_d,
           "windows": len(res.times), "launches": launches}
    assert same, (where, "mega differs from the flow tier", abs_d)
    _expect(launches, f"{where} mega", block=len(res.times))
    return rec, mres


def phase_golden(device) -> dict:
    rec = {"phase": "golden"}
    for build_grid in (_golden_routing, _golden_pathology):
        sweep, fname, fk, ck = build_grid()
        with open(os.path.join(GOLDEN, fname)) as f:
            n_steps = json.load(f)["n_steps"]
        reset_counts()
        t0 = time.perf_counter()
        res = sweep.run(n_steps=n_steps, device=device)
        wall = time.perf_counter() - t0
        launches = counts()
        n = _check_golden(res.summary(), os.path.join(GOLDEN, fname), fk, ck)
        rec[fname] = {"points": n, "steps": n_steps, "wall_s": wall,
                      "steps_per_s": n_steps / wall, "launches": launches}
        _launches_once_a_step(launches, n_steps, fname)
        mega, mres = _mega_rerun(sweep, res, n_steps, None, device, fname)
        _check_golden(mres.summary(), os.path.join(GOLDEN, fname), fk, ck)
        rec[fname]["mega"] = mega
        if fname == "pfc_pathology.json":
            vic = {s: res[f"{s}/holvictim"].summary()["victim_slowdown"]
                   for s in ("DCQCN_REV", "DCQCN", "PFC_ONLY")}
            rec["victim_slowdown"] = vic
            assert vic["DCQCN_REV"] < vic["DCQCN"] < vic["PFC_ONLY"], vic
        else:
            again = sweep.run(n_steps=n_steps, device=device)
            same = _result_diff(again, res)[0]
            rec["rerun_bitwise_equal"] = same
            assert same, "two runs of one Sweep differ on the card"
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 6: datacenter scale (the main path whose launches are counted)
# ---------------------------------------------------------------------------

def _dc_sweep():
    from repro_torch.core import CCSpec, ScenarioSpec, Sweep, cc
    from repro_torch.net import FabricSpec
    spec = ScenarioSpec.permutation(4096, seed=0,
                                    fabric=FabricSpec.dragonfly(4, 4, 4))
    cfgs = {f"{m}+{n}+{r}": CCSpec(marking=m, notification=n, reaction=r)
            for m in cc.MARKING.names() for n in cc.NOTIFICATION.names()
            for r in cc.REACTION.names()}
    return Sweep.grid(configs=cfgs, scenarios={"dfly272_f4096": spec})


def phase_dc(device) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.fluid import dense_reduce_rows
    sweep = _dc_sweep()
    R = len(sweep.points)
    scn = sweep.points[0].scenario
    # full width on the card against the CPU (plain versions, the same
    # ordered walk): every trace and final-state leaf; the first run
    # also warms the card
    t0 = time.perf_counter()
    card = sweep.run(n_steps=DC_CHECK_STEPS, trace_every=100, device=device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = sweep.run(n_steps=DC_CHECK_STEPS, trace_every=100, device="cpu")
    cpu_s = time.perf_counter() - t0
    bitwise, abs_d, rel_d = _result_diff(card, host)
    check = {"steps": DC_CHECK_STEPS, "bitwise_equal": bitwise,
             "max_abs_diff": abs_d, "max_rel_diff": rel_d,
             "card_wall_s": card_s, "cpu_wall_s": cpu_s}
    n_steps = DC_STEPS
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = sweep.run(n_steps=n_steps, trace_every=100, device=device)
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    fin = res.final
    finite = all(np.isfinite(np.asarray(x, np.float64)).all()
                 for x in fin[:-2])
    delivered = float(fin.delivered.sum())
    rec = {"phase": "dc", "runs": R, "flows": int(scn.routes.shape[0]),
           "links": int(scn.capacity.shape[0]),
           "dense_rows": dense_reduce_rows(scn), "steps": n_steps,
           "wall_s": wall, "steps_per_s": n_steps / wall,
           "run_steps_per_s": R * n_steps / wall,
           "max_memory_allocated": peak, "launches": launches,
           "launches_per_step": {k: v / n_steps for k, v in
                                 launches.items()},
           "finite": finite, "delivered_gb": delivered / 1e9,
           "card_vs_cpu": check, "profile": profile_steps(sweep, device)}
    emit(rec)
    # golden tolerance (rtol 2e-3 of each field's scale) where not bitwise
    assert bitwise or rel_d <= 2e-3, check
    assert finite and delivered > 0, rec
    assert res.traces.delivered.shape == (R, n_steps // 100, 4096)
    _launches_once_a_step(launches, n_steps, "dc")
    rec["result"] = res
    return rec


# ---------------------------------------------------------------------------
# phase 7: the dc batch through the megakernel
# ---------------------------------------------------------------------------

def _nbytes(*trees) -> int:
    n = 0
    for t in trees:
        for x in t:
            for y in (x.values() if isinstance(x, dict) else [x]):
                n += y.numel() * y.element_size()
    return n


def _mega_bound(stg, n_steps: int, block: bool) -> tuple[float, str]:
    """(least ms, what bounds it) of one megakernel launch: the state
    read and written once, the scenario read once, the trace written
    once, against MEGA_OPS_* float32 operations a step."""
    sd, st = stg.sd, stg.state
    R, F, K, H = sd.alt_routes.shape
    scn = [getattr(sd, f) for f in (
        "gen_rate", "t_start", "t_stop", "volume", "cap_ext", "nic_buffer",
        "jitter", "sink_ext", "rtt", "alt_routes", "alt_hops", "vc",
        "red_perm", "red_off", "pool_perm")]
    trace = 4 * R * F * (3 if block else 2) + 4 * R * F + 16 * R
    nbytes = 2 * _nbytes(st) + _nbytes(scn) + trace
    entries = int(stg.plan.seg_rows.numel())
    ops = n_steps * (MEGA_OPS_PER_FLOW_HOP * R * F * H
                     + MEGA_OPS_PER_ENTRY * entries)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / FP32_FLOPS * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def phase_mega(device, dc: dict) -> tuple[dict, dict, dict]:
    import numpy as np
    import torch
    sweep = _dc_sweep()
    R = len(sweep.points)
    F = int(sweep.points[0].scenario.routes.shape[0])
    n = DC_CHECK_STEPS
    # megastep: n launches, StepTrace by StepTrace against the flow tier
    stg = sweep.prepare(n, device=device)
    stm = sweep.prepare(n, device=device, use_kernels="mega")
    x, flow = stg.state, []
    for _ in range(n):
        x, tr = stg.step(x)
        flow.append(tr)
    reset_counts()
    y = stm.state
    for i in range(n):
        y, tr = stm.step(y)
        for f, u, v in zip(tr._fields, flow[i], tr):
            assert torch.equal(u, v), ("megastep", i, f)
    step_launches = counts()
    _expect(step_launches, "megastep", step=n)
    for f in x._fields:
        a, b = getattr(x, f), getattr(y, f)
        pairs = a.items() if isinstance(a, dict) else [(f, a)]
        for k, u in pairs:
            assert torch.equal(u, b[k] if isinstance(b, dict) else b), k
    del flow
    st0 = stm.state
    # CUDA events over eager calls: a megakernel launch outlasts its
    # host cost, so this is its device time; the plain version (the
    # flow tier's step) is host-bound, and this is what it costs
    step_ms = _event_ms(lambda: stm.step(st0), 20)
    plain_ms = _event_ms(lambda: stg.step(st0), 5)
    step_bound, step_by = _mega_bound(stm, 1, False)
    # megastep_block at ragged flow counts
    ragged = {}
    for nf in (1, 127, 129, 8193):
        sw = _flows_sweep(nf)
        a = sw.run(n_steps=200, trace_every=10, device=device)
        b = sw.run(n_steps=200, trace_every=10, device=device,
                   use_kernels="mega")
        same, abs_d, _ = _result_diff(b, a)
        ragged[nf] = same
        assert same, ("megastep_block", nf, abs_d)
    # the dc sweep, one launch per trace window
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = sweep.run(n_steps=DC_STEPS, trace_every=100, device=device,
                    use_kernels="mega")
    wall = time.perf_counter() - t0
    block_launches = counts()
    peak = torch.cuda.max_memory_allocated()
    same, abs_d, _ = _result_diff(res, dc["result"])
    windows = DC_STEPS // 100
    stb = sweep.prepare(100, trace_every=100, device=device,
                        use_kernels="mega")
    block_ms = _event_ms(lambda: stb.block(stb.state), 3)
    block_plain_ms = _event_ms(
        lambda: [stg.step(st0) for _ in range(100)], 1)
    block_bound, block_by = _mega_bound(stb, 100, True)
    rec = {"phase": "mega", "runs": R, "flows": F,
           "megastep": {"steps": n, "bitwise_equal_flow_tier": True,
                        "launches": step_launches, "us": step_ms * 1e3,
                        "plain_us": plain_ms * 1e3,
                        "bound_us": step_bound * 1e3},
           "megastep_block_ragged_bitwise": ragged,
           "sweep": {"steps": DC_STEPS, "windows": windows, "wall_s": wall,
                     "steps_per_s": DC_STEPS / wall,
                     "run_steps_per_s": R * DC_STEPS / wall,
                     "flow_tier_steps_per_s": dc["steps_per_s"],
                     "max_memory_allocated": peak,
                     "bitwise_equal_flow_tier": same, "max_abs_diff": abs_d,
                     "launches": block_launches,
                     "window_us": block_ms * 1e3,
                     "plain_window_us": block_plain_ms * 1e3,
                     "bound_us": block_bound * 1e3},
           "profile": profile_steps(sweep, device, n=100, mega=True)}
    emit(rec)
    assert same, ("mega dc sweep differs from the flow tier", abs_d)
    assert res.traces.delivered.shape == (R, windows, F), \
        res.traces.delivered.shape
    _expect(block_launches, "mega dc", block=windows)
    rows = {
        "megastep": {"launches": step_launches["megastep"], "ms": step_ms,
                     "plain_ms": plain_ms, "bound_ms": step_bound,
                     "bound_by": step_by},
        "megastep_block": {"launches": block_launches["megastep_block"],
                           "ms": block_ms, "plain_ms": block_plain_ms,
                           "bound_ms": block_bound, "bound_by": block_by}}
    for name, row in rows.items():
        row.update({"name": name, "route": "cuda",
                    "source": WHOLE_STEP[name][0],
                    "replaces": WHOLE_STEP[name][1], "max_abs_err": 0.0,
                    "library_ms": None})
    return rec, rows["megastep"], rows["megastep_block"]


# ---------------------------------------------------------------------------
# phase 8: a hotspot, too skewed for the dense walk
# ---------------------------------------------------------------------------

def _hotspot_sweep():
    """Half of 4096 flows into host 0 of the DC cell's dragonfly, the
    three paper schemes; flows open at 20 us so the window is busy."""
    from repro_torch.core import CCScheme, PAPER_CONFIG, Sweep
    from repro_torch.core.workloads import hotspot
    from repro_torch.net import FabricSpec
    spec = hotspot(4096, 272, t_start=20e-6).spec(
        fabric=FabricSpec.dragonfly(4, 4, 4))
    return Sweep.grid(configs={s.name: PAPER_CONFIG.replace(scheme=s)
                               for s in CCScheme},
                      scenarios={"hot4096": spec})


def phase_hotspot(device) -> dict:
    sweep = _hotspot_sweep()
    stg = sweep.prepare(1, device=device)
    assert stg.dense_rows == 0, stg.dense_rows
    K = stg.sd.alt_routes.shape[2]
    passes = 3 if K == 1 else 4
    runs, rec = {}, {"phase": "hotspot", "runs": len(sweep.points),
                     "flows": 4096, "steps": HOT_STEPS}
    for tag, kw in (("segment_sum", {}), ("pallas", {"reduce": "pallas"})):
        reset_counts()
        t0 = time.perf_counter()
        runs[tag] = sweep.run(n_steps=HOT_STEPS, trace_every=100,
                              device=device, **kw)
        wall = time.perf_counter() - t0
        launches = counts()
        rec[tag] = {"wall_s": wall, "steps_per_s": HOT_STEPS / wall,
                    "launches": launches}
        _expect(launches, f"hotspot {tag}", cc=HOT_STEPS,
                seg=passes * HOT_STEPS)
    t0 = time.perf_counter()
    runs["cpu"] = sweep.run(n_steps=HOT_STEPS, trace_every=100,
                            device="cpu")
    rec["cpu_wall_s"] = time.perf_counter() - t0
    rec["pallas_bitwise_equal"] = _result_diff(runs["pallas"],
                                               runs["segment_sum"])[0]
    rec["cpu_bitwise_equal"] = _result_diff(runs["cpu"],
                                            runs["segment_sum"])[0]
    rec["longest_queue"] = int((stg.plan.seg_off[1:]
                                - stg.plan.seg_off[:-1]).max())
    rec["delivered_gb"] = float(runs["segment_sum"].final.delivered.sum()
                                / 1e9)
    emit(rec)
    assert rec["pallas_bitwise_equal"] and rec["cpu_bitwise_equal"], rec
    assert rec["delivered_gb"] > 0, rec
    return rec


# ---------------------------------------------------------------------------
# phase 9: the attention kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN = {
    # name: (source, TPU kernel it replaces)
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:103"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:71"),
}
#: kernel against plain version: atol = rtol (tests/test_kernels.py)
ATTN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
#: gemma2-27b's attention: query heads, kv heads, head_dim, the query
#: scale 1/sqrt(144) and the logit softcap
GEMMA_HEADS = (32, 16, 128)
GEMMA_SCALE = 1.0 / 12.0
GEMMA_CAP = 50.0
#: the serve cell: requests on slots, prompt lengths (ragged, past the
#: 4096-token window), new tokens each and the cache length
SERVE_REQUESTS, SERVE_SLOTS = 8, 4
SERVE_PROMPT = (4100, 4200)
SERVE_NEW, SERVE_MAX_LEN = 16, 4352
#: kernel path against the plain path, gemma2-27b in bfloat16 at batch
#: 1: max |logit diff| <= SERVE_LOGIT_RTOL * max |plain logit|.  The
#: logits come out of a bfloat16 product (ulp 2^-8 relative), and the
#: kernels keep the softmax weights in float32 where the plain version
#: rounds them to bfloat16 (the 2e-2 kernel bound) in each of 46 layers.
SERVE_LOGIT_RTOL = 5e-2
#: the same in float32 (the two-layer cut): the kernels' 3e-5 bound on
#: each attention output, through 2 layers
SERVE_F32_LOGIT_RTOL = 1e-4


def _held(got, want, dtype: str, where: str) -> float:
    """max |got - want|; raises unless |got - want| <= tol * (1 + |want|)
    everywhere (``np.allclose`` with atol = rtol = ATTN_TOL[dtype])."""
    import torch
    tol = ATTN_TOL[dtype]
    d = (got.float() - want.float()).abs()
    bad = d > tol + tol * want.float().abs()
    err = float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() \
        else 0.0
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{where}: kernel differs from its plain "
                             f"version beyond {tol}: max |diff| = {err}")
    return err


def _flash_flops(q_shape, s: int, *, causal: bool,
                 window: int | None) -> float:
    """Multiply-add flops (2 a MAC, QK^T and PV) of the (query position,
    key) pairs the masks keep, for every head: the work these inputs
    need, whatever blocks a kernel skips or not."""
    b, t, h, d = q_shape
    pairs = 0
    for qpos in range(t):
        hi = min(s, qpos + 1) if causal else s
        lo = max(0, qpos - window + 1) if window is not None else 0
        pairs += max(hi - lo, 0)
    return 4.0 * b * h * d * pairs


def _randn(g, shape, dtype, device, sd: float = 0.3):
    import torch
    return (torch.randn(shape, generator=g, device=device) * sd).to(dtype)


#: tests/test_kernels.py:32-40 (b, t, h, kv, d, causal, window, cap),
#: then gemma2's heads at a prompt's full length (local and global)
FLASH_EDGE = [
    (1, 128, 4, 2, 64, True, None, 0.0),
    (2, 256, 8, 8, 64, True, None, 50.0),          # g = 1
    (1, 200, 4, 1, 64, True, 64, 0.0),             # ragged + window, g = 4
    (2, 128, 6, 2, 128, False, None, 0.0),         # non-causal
    (1, 512, 4, 2, 64, True, 128, 30.0),
    (1, 96, 2, 2, 32, True, 32, 0.0),
    (1, 80, 4, 4, 64, True, None, 0.0),            # ragged tail block
    (1, 4200, 32, 16, 128, True, 4096, GEMMA_CAP),
    (1, 4200, 32, 16, 128, True, None, GEMMA_CAP),
]
#: tests/test_kernels.py:84-88 (b, s, h, kv, d, cap), then gemma2's
#: decode at the serve cell's cache lengths (global and local ring)
DECODE_EDGE = [
    (2, 256, 8, 2, 64, 0.0),
    (1, 1000, 4, 1, 64, 50.0),
    (3, 128, 16, 8, 128, 0.0),
    (1, 64, 4, 4, 32, 0.0),
    (4, SERVE_MAX_LEN, 32, 16, 128, GEMMA_CAP),
    (4, 4096, 32, 16, 128, GEMMA_CAP),
]


#: logits that reach the cap: q and k at 2x unit scale (logit std ~4 at
#: 1/sqrt(64), ~3.8 at gemma2's 1/12 and d = 128), V at unit scale so the
#: outputs are O(1) against the bounds.  (b, t, h, kv, d, window, cap)
CAP_QK = 2.0
FLASH_CAP = [
    (1, 128, 4, 2, 64, 48, 2.0),
    (1, 200, 4, 1, 64, 64, 5.0),                   # ragged, g = 4
    (2, 256, 8, 8, 64, None, 50.0),                # g = 1
    (1, 4200, 32, 16, 128, 4096, 5.0),
    (1, 4200, 32, 16, 128, 4096, GEMMA_CAP),
    (1, 4200, 32, 16, 128, None, GEMMA_CAP),
]
#: (b, s, h, kv, d, cap)
DECODE_CAP = [
    (1, 1000, 4, 1, 64, 2.0),
    (2, 300, 8, 4, 64, 5.0),
    (2, 256, 8, 2, 64, 50.0),
    (4, SERVE_MAX_LEN, 32, 16, 128, 5.0),
    (4, SERVE_MAX_LEN, 32, 16, 128, GEMMA_CAP),
    (4, 4096, 32, 16, 128, GEMMA_CAP),
]


def _beyond(nocap, want, dtype: str, where: str) -> float:
    """max |nocap - want|; raises unless dropping the softcap moves the
    output beyond the bound somewhere (so a kernel without it fails)."""
    tol = ATTN_TOL[dtype]
    d = (nocap.float() - want.float()).abs()
    if not bool((d > tol + tol * want.float().abs()).any()):
        raise AssertionError(f"{where}: the softcap moves the output by "
                             f"no more than the bound {tol}")
    return float(d.max())


def _cap_cases(device, g) -> dict:
    """Both kernels where the softcap bites, each against its plain
    version run in float32 on the same values: the plain bf16 version
    rounds its logits to bf16, which at |logit| ~ 14 is beyond 2e-2 by
    itself (the kernels, like the TPU kernels, keep them in float32)."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    errs, moved = {"flash": {}, "decode": {}}, {}
    for b, t, h, kv, d, window, cap in FLASH_CAP:
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(g, (b, t, h, d), dt, device, CAP_QK)
            k = _randn(g, (b, t, kv, d), dt, device, CAP_QK)
            v = _randn(g, (b, t, kv, d), dt, device, 1.0)
            kw = dict(window=window, scale=GEMMA_SCALE if h == 32 else None)
            f32 = [x.float() for x in (q, k, v)]
            want = FA.flash_attention_plain(*f32, softcap=cap, **kw)
            tag = f"cap {b}x{t}x{h}/{kv}x{d} w{window} cap{cap} {dt}"
            errs["flash"][tag] = _held(
                FA.flash_attention(q, k, v, softcap=cap, **kw),
                want, str(dt)[6:], f"flash {tag}")
            moved[tag] = _beyond(FA.flash_attention_plain(*f32, **kw), want,
                                 str(dt)[6:], f"flash {tag}")
            del q, k, v, f32, want
    for b, s, h, kv, d, cap in DECODE_CAP:
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(g, (b, h, d), dt, device, CAP_QK)
            k = _randn(g, (b, s, kv, d), dt, device, CAP_QK)
            v = _randn(g, (b, s, kv, d), dt, device, 1.0)
            valid = torch.rand((b, s), generator=g, device=device) > 0.3
            kw = dict(scale=GEMMA_SCALE if h == 32 else None)
            f32 = [x.float() for x in (q, k, v)]
            want = DA.decode_attention_plain(*f32, valid, softcap=cap, **kw)
            tag = f"cap {b}x{s}x{h}/{kv}x{d} cap{cap} {dt}"
            errs["decode"][tag] = _held(
                DA.decode_attention(q, k, v, valid, softcap=cap, **kw),
                want, str(dt)[6:], f"decode {tag}")
            moved[tag] = _beyond(DA.decode_attention_plain(*f32, valid, **kw),
                                 want, str(dt)[6:], f"decode {tag}")
    torch.cuda.empty_cache()
    return errs, moved


def _flash_edges(device, g) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as FA
    errs = {}
    for b, t, h, kv, d, causal, window, cap in FLASH_EDGE:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = [_randn(g, sh, dt, device) for sh in
                       ((b, t, h, d), (b, t, kv, d), (b, t, kv, d))]
            kw = dict(causal=causal, window=window, softcap=cap,
                      scale=GEMMA_SCALE if h == 32 else None)
            tag = f"{b}x{t}x{h}/{kv}x{d} w{window} cap{cap} {dt}"
            errs[tag] = _held(FA.flash_attention(q, k, v, **kw),
                              FA.flash_attention_plain(q, k, v, **kw),
                              str(dt)[6:], f"flash {tag}")
    # a q block whose kv blocks are all skipped: t > s under a window, so
    # positions >= s + window - 1 see no key; the kernel (like the TPU
    # kernel) returns 0 there, the plain version the mean of V
    b, t, s, window = 1, 256, 64, 32
    h, kv, d = GEMMA_HEADS
    for dt in (torch.float32, torch.bfloat16):
        q = _randn(g, (b, t, h, d), dt, device)
        k, v = [_randn(g, (b, s, kv, d), dt, device) for _ in range(2)]
        got = FA.flash_attention(q, k, v, window=window, softcap=GEMMA_CAP)
        want = FA.flash_attention_plain(q, k, v, window=window,
                                        softcap=GEMMA_CAP)
        seen = s + window - 1
        tag = f"all_skipped t{t} s{s} w{window} {dt}"
        errs[tag] = _held(got[:, :seen], want[:, :seen], str(dt)[6:], tag)
        assert not bool(got[:, seen:].any()), tag
    return errs


def _decode_edges(device, g) -> dict:
    import torch
    from repro_torch.kernels import decode_attention as DA
    errs = {}
    for b, s, h, kv, d, cap in DECODE_EDGE:
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(g, (b, h, d), dt, device)
            k, v = [_randn(g, (b, s, kv, d), dt, device) for _ in range(2)]
            valid = torch.rand((b, s), generator=g, device=device) > 0.3
            kw = dict(softcap=cap, scale=GEMMA_SCALE if h == 32 else None)
            tag = f"{b}x{s}x{h}/{kv}x{d} cap{cap} {dt}"
            errs[tag] = _held(DA.decode_attention(q, k, v, valid, **kw),
                              DA.decode_attention_plain(q, k, v, valid, **kw),
                              str(dt)[6:], f"decode {tag}")
    # a single valid slot: the output is that slot's V row
    q = _randn(g, (1, 4, 32), torch.float32, device)
    k, v = [_randn(g, (1, 64, 2, 32), torch.float32, device)
            for _ in range(2)]
    valid = torch.zeros((1, 64), dtype=torch.bool, device=device)
    valid[0, 17] = True
    got = DA.decode_attention(q, k, v, valid)
    errs["single_valid_slot"] = _held(
        got, v[0, 17].repeat_interleave(2, 0)[None], "float32",
        "decode single valid slot")
    return errs


def _flex_call(qT, kT, vT, *, window, valid):
    """One compiled ``flex_attention`` call computing the kernels'
    function at gemma2's scale and softcap, on [b, heads, len, d]
    tensors: causal (and the window) for a prefill, the valid slots for
    a decode query.  Timed here only; the port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    b, _, t, _ = qT.shape
    s = kT.shape[2]

    def softcap(score, bb, hh, qi, ki):
        return torch.tanh(score / GEMMA_CAP) * GEMMA_CAP

    if valid is not None:
        def keep(bb, hh, qi, ki):
            return valid[bb, ki]
        bm = create_block_mask(keep, b, None, t, s, device=qT.device)
    elif window is None:
        def keep(bb, hh, qi, ki):
            return ki <= qi
        bm = create_block_mask(keep, None, None, t, s, device=qT.device)
    else:
        def keep(bb, hh, qi, ki):
            return (ki <= qi) & (ki > qi - window)
        bm = create_block_mask(keep, None, None, t, s, device=qT.device)
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(qT, kT, vT, score_mod=softcap, block_mask=bm,
                      scale=GEMMA_SCALE, enable_gqa=True)


def phase_attention(device) -> dict:
    """Both kernels against their plain versions at every case; timed at
    the serve cell's shapes (batch 4, prompt 4200, cache 4352, bf16),
    with the bound, flex_attention at softcap 50 (the library call of
    the same function) and, at softcap 0, scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device=device).manual_seed(9)
    flash_errs = _flash_edges(device, g)
    decode_errs = _decode_edges(device, g)
    cap_errs, moved = _cap_cases(device, g)
    flash_errs.update(cap_errs["flash"])
    decode_errs.update(cap_errs["decode"])
    h, kv, d = GEMMA_HEADS
    bf = torch.bfloat16
    rows, rec = {}, {"phase": "attention", "flash_max_abs_err": flash_errs,
                     "decode_max_abs_err": decode_errs,
                     "nocap_max_abs_diff": moved}

    # flash at a prefill of the serve cell: 4 slots x 4200 positions
    b, t = SERVE_SLOTS, SERVE_PROMPT[1]
    q = _randn(g, (b, t, h, d), bf, device)
    k, v = [_randn(g, (b, t, kv, d), bf, device) for _ in range(2)]
    times = {}
    for layer, window in (("global", None), ("local", 4096)):
        kw = dict(window=window, softcap=GEMMA_CAP, scale=GEMMA_SCALE)
        ms = _event_ms(lambda: FA.flash_attention(q, k, v, **kw), 3)
        plain_ms = _event_ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                             1)
        fl = _flash_flops(q.shape, t, causal=True, window=window)
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = fl / BF16_FLOPS * 1e3
        times[layer] = {"us": ms * 1e3, "plain_us": plain_ms * 1e3,
                        "bound_us": max(b_ms, o_ms) * 1e3,
                        "bound_by": "bytes" if b_ms >= o_ms else "operations",
                        "flops": fl, "tflops_per_s": fl / ms / 1e9}
        torch.cuda.empty_cache()
    # scaled_dot_product_attention computes the same function at softcap
    # 0 (boolean mask, GQA): time it beside the kernel at softcap 0
    qT, kT, vT = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pos = torch.arange(t, device=device)
    local_mask = ((pos[None, :] <= pos[:, None])
                  & (pos[None, :] > pos[:, None] - 4096))
    sdpa = {}
    for layer, window, lib in (
            ("global", None, lambda: F.scaled_dot_product_attention(
                qT, kT, vT, is_causal=True, scale=GEMMA_SCALE,
                enable_gqa=True)),
            ("local", 4096, lambda: F.scaled_dot_product_attention(
                qT, kT, vT, attn_mask=local_mask, scale=GEMMA_SCALE,
                enable_gqa=True))):
        kw = dict(window=window, scale=GEMMA_SCALE)
        err = _held(FA.flash_attention(q, k, v, **kw),
                    lib().transpose(1, 2), "bfloat16", f"sdpa {layer}")
        sdpa[layer] = {
            "library_us": _event_ms(lib, 5) * 1e3,
            "kernel_softcap0_us": _event_ms(
                lambda: FA.flash_attention(q, k, v, **kw), 3) * 1e3,
            "max_abs_err_vs_kernel": err}
    flex = {}
    for layer, window in (("global", None), ("local", 4096)):
        lib = _flex_call(qT, kT, vT, window=window, valid=None)
        err = _held(FA.flash_attention(q, k, v, window=window,
                                       softcap=GEMMA_CAP, scale=GEMMA_SCALE),
                    lib().transpose(1, 2), "bfloat16", f"flex {layer}")
        flex[layer] = {"library_us": _event_ms(lib, 5) * 1e3,
                       "max_abs_err_vs_kernel": err}
    rec["flash"] = {"shape": [b, t, h, kv, d], "dtype": "bfloat16",
                    "softcap": GEMMA_CAP, "times": times,
                    "flex_softcap50": flex, "sdpa_softcap0": sdpa}
    del q, k, v, qT, kT, vT, local_mask
    torch.cuda.empty_cache()
    rows["flash_attention"] = {
        "ms": times["global"]["us"] / 1e3,
        "plain_ms": times["global"]["plain_us"] / 1e3,
        "bound_ms": times["global"]["bound_us"] / 1e3,
        "bound_by": times["global"]["bound_by"],
        "library_ms": flex["global"]["library_us"] / 1e3,
        "max_abs_err": max(flash_errs.values())}

    # decode at a step of the serve cell: 4 slots, global cache of 4352
    # slots (4215 valid) and a full local ring of 4096
    times, sdpa, flex = {}, {}, {}
    for layer, s, n_valid in (("global", SERVE_MAX_LEN, 4215),
                              ("local", 4096, 4096)):
        q = _randn(g, (b, h, d), bf, device)
        k, v = [_randn(g, (b, s, kv, d), bf, device) for _ in range(2)]
        valid = (torch.arange(s, device=device) < n_valid).expand(b, s)
        valid = valid.contiguous()
        kw = dict(softcap=GEMMA_CAP, scale=GEMMA_SCALE)
        ms = _event_ms(lambda: DA.decode_attention(q, k, v, valid, **kw), 20)
        plain_ms = _event_ms(
            lambda: DA.decode_attention_plain(q, k, v, valid, **kw), 5)
        # K/V rows of the valid slots only (the kernel loads no other),
        # q in and out in bf16, the mask
        nbytes = 2 * (2 * b * n_valid * kv * d + 2 * q.numel()) \
            + valid.numel()
        fl = 4.0 * b * h * n_valid * d
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = fl / BF16_FLOPS * 1e3
        times[layer] = {"us": ms * 1e3, "plain_us": plain_ms * 1e3,
                        "bound_us": max(b_ms, o_ms) * 1e3,
                        "bound_by": "bytes" if b_ms >= o_ms else "operations",
                        "bytes": nbytes, "tb_per_s": nbytes / ms / 1e9}
        qT, kT, vT = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        kT, vT = kT.contiguous(), vT.contiguous()
        mask = valid[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qT, kT, vT, attn_mask=mask, scale=GEMMA_SCALE, enable_gqa=True)
        err = _held(DA.decode_attention(q, k, v, valid, scale=GEMMA_SCALE),
                    lib()[:, :, 0], "bfloat16", f"sdpa decode {layer}")
        sdpa[layer] = {
            "library_us": _event_ms(lib, 20) * 1e3,
            "kernel_softcap0_us": _event_ms(lambda: DA.decode_attention(
                q, k, v, valid, scale=GEMMA_SCALE), 20) * 1e3,
            "max_abs_err_vs_kernel": err}
        lib = _flex_call(qT, kT, vT, window=None, valid=valid)
        err = _held(DA.decode_attention(q, k, v, valid, **kw),
                    lib()[:, :, 0], "bfloat16", f"flex decode {layer}")
        flex[layer] = {"library_us": _event_ms(lib, 20) * 1e3,
                       "max_abs_err_vs_kernel": err}
    rec["decode"] = {"shape": [b, SERVE_MAX_LEN, h, kv, d],
                     "dtype": "bfloat16", "softcap": GEMMA_CAP,
                     "times": times, "flex_softcap50": flex,
                     "sdpa_softcap0": sdpa}
    rows["decode_attention"] = {
        "ms": times["global"]["us"] / 1e3,
        "plain_ms": times["global"]["plain_us"] / 1e3,
        "bound_ms": times["global"]["bound_us"] / 1e3,
        "bound_by": times["global"]["bound_by"],
        "library_ms": flex["global"]["library_us"] / 1e3,
        "max_abs_err": max(decode_errs.values())}
    emit(rec)
    torch.cuda.empty_cache()
    for name, row in rows.items():
        row.update({"name": name, "route": "cuda", "source": ATTN[name][0],
                    "replaces": ATTN[name][1], "launches": None})
    return rows


# ---------------------------------------------------------------------------
# phases 10-12: serving gemma2-27b
# ---------------------------------------------------------------------------

def _prompts(vocab: int, n: int, lo: int, hi: int, seed: int):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [[int(x) for x in rng.randint(2, vocab, int(rng.randint(lo,
                                                                   hi + 1)))]
            for _ in range(n)]


def _timed(eng) -> dict:
    """Wrap ``eng``'s prefill and step calls to record (seconds, grid
    tokens, end time) of each, synchronised with the card."""
    import torch
    rec = {"prefill": [], "decode": []}

    def wrap(fn, key):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec[key].append((t1 - t0, int(a[0].size), t1))
            return out
        return call

    eng._prefill = wrap(eng._prefill, "prefill")
    eng._step = wrap(eng._step, "decode")
    return rec


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _kernel_vs_plain(params, cfg, prompt, device) -> dict:
    """Prefill and first decode logits at batch 1 through the kernels
    and through the plain path (the same params with ``use_pallas``
    off): their differences."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as T
    plain = dataclasses.replace(cfg, use_pallas=False)
    tok = torch.tensor([prompt], dtype=torch.int32, device=device)
    t, n_layers = tok.shape[1], cfg.n_layers
    with torch.no_grad():
        reset_counts()
        lk, ck = T.prefill(params, cfg, tok, SERVE_MAX_LEN)
        nxt = lk[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        dk, _ = T.decode_step(params, cfg, nxt, ck, t)
        del ck
        _expect(counts(), "batch 1", flash=n_layers, decode=n_layers)
        lr, cr = T.prefill(params, plain, tok, SERVE_MAX_LEN)
        dr, _ = T.decode_step(params, plain, nxt, cr, t)
        del cr
        _expect(counts(), "batch 1 plain", flash=n_layers, decode=n_layers)
    cmp = {}
    for tag, a, b in (("prefill", lk, lr), ("decode", dk, dr)):
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        cmp[tag] = {"max_abs_diff": diff, "max_abs_logit": scale,
                    "rel": diff / scale,
                    "mean_abs_diff": float((a - b).abs().mean()),
                    "argmax_equal": bool(torch.equal(a.argmax(-1),
                                                     b.argmax(-1))),
                    "finite": bool(torch.isfinite(a).all())}
    return cmp


def _profile_decode(cfg, params, prompts, device, decode_us: float,
                    n: int = 5) -> dict:
    """``n`` of the engine's decode steps on the serve cell's 4 slots
    (prompts cut to the shortest length), each followed by the engine's
    host-side read of the logits: wall ms a step without and with
    torch.profiler, device busy ms a step (sum of kernel and copy
    durations on the one stream), the idle share against both walls,
    and the heaviest kernels.  Should the trace hold no
    ``decode_attention`` kernel (a ctypes launch the profiler missed),
    busy time adds its launches at ``decode_us`` each, and says so."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeConfig, ServingEngine
    eng = ServingEngine(cfg, params, ServeConfig(
        batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, eos_token=-1),
        device=device)
    t = SERVE_PROMPT[0]
    grid = np.asarray([p[:t] for p in prompts[:SERVE_SLOTS]], np.int32)
    logits, caches = eng._prefill(grid)
    pos = t

    def steps(k):
        nonlocal logits, caches, pos
        for _ in range(k):
            cur = logits[:, -1].float().cpu().numpy().argmax(-1)
            logits, caches = eng._step(cur.astype(np.int32), caches, pos)
            pos += 1
        logits[:, -1].float().cpu()

    steps(2)
    t0 = time.perf_counter()
    steps(n)
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(n)
        pwall = (time.perf_counter() - t0) / n
    del eng, logits, caches
    torch.cuda.empty_cache()
    rec = {"profiled_steps": n, "wall_ms_per_step": wall * 1e3,
           "profiled_wall_ms_per_step": pwall * 1e3}
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        rec["device"] = "not measured (the profiler saw no device events)"
        return rec
    per = {}
    for e in dev:
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(per.values()) / n / 1e6
    seen = sum(us for name, us in per.items() if "decode_" in name) / n
    rec["decode_attention_us_per_step_in_trace"] = seen
    if not seen:
        busy += cfg.n_layers * decode_us / 1e6
        rec["busy_adds_decode_attention_from_phase_attention_us"] = \
            cfg.n_layers * decode_us
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    rec.update({
        "device_busy_ms_per_step": busy * 1e3,
        "device_idle_share": 1.0 - busy / wall,
        "device_idle_share_profiled": 1.0 - busy / pwall,
        "device_ops_per_step": len(dev) / n,
        "top_device_us_per_step": [[k[:80], v / n] for k, v in top]})
    return rec


def phase_serve(device, decode_us: float) -> dict:
    """gemma2-27b, full width and depth, bf16, through the engine;
    ``decode_us`` is phase_attention's time of one decode launch."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = dataclasses.replace(get_config("gemma2-27b"), use_pallas=True)
    n_layers = cfg.n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(T.param_defs(cfg), 0, getattr(torch, cfg.dtype),
                         device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = T.n_params(params) * 2
    eng = ServingEngine(cfg, params, ServeConfig(
        batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, eos_token=-1),
        device=device)
    prompts = _prompts(cfg.vocab, SERVE_REQUESTS, *SERVE_PROMPT, seed=0)
    calls = _timed(eng)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=SERVE_NEW)
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats
    n_prefill, n_decode = len(calls["prefill"]), len(calls["decode"])
    prefill_s = sum(c[0] for c in calls["prefill"])
    decode_s = sum(c[0] for c in calls["decode"])
    prompt_tokens = sum(len(p) for p in prompts)
    rec = {"phase": "serve", "model": cfg.name, "layers": n_layers,
           "params": T.n_params(params), "param_bytes": param_bytes,
           "dtype": cfg.dtype, "init_s": init_s, "requests": len(prompts),
           "slots": SERVE_SLOTS, "prompt_tokens": prompt_tokens,
           "prompt_lengths": [len(p) for p in prompts],
           "new_tokens": SERVE_NEW, "max_len": SERVE_MAX_LEN,
           "stats": st, "wall_s": wall,
           "ttft_s": calls["prefill"][0][2] - t0,
           "prefill_s": [c[0] for c in calls["prefill"]],
           "prefill_tokens_per_s": prompt_tokens / prefill_s,
           "prefill_grid_tokens_per_s":
               sum(c[1] for c in calls["prefill"]) / prefill_s,
           "decode_step_ms": decode_s / max(n_decode, 1) * 1e3,
           "decode_tokens_per_s": SERVE_SLOTS * n_decode / decode_s,
           "generated_tokens": sum(len(o) for o in outs),
           "max_memory_allocated": peak, "launches": launches}
    assert st == {"prefills": 2, "refills": 0, "decode_steps": 30}, st
    assert all(len(o) == SERVE_NEW for o in outs), [len(o) for o in outs]
    _expect(launches, "serve", flash=n_layers * n_prefill,
            decode=n_layers * n_decode)
    del eng
    torch.cuda.empty_cache()

    rec["decode_profile"] = _profile_decode(cfg, params, prompts, device,
                                            decode_us)
    # the kernel path against the plain path (use_pallas off) at batch 1:
    # the prefill logits and the first decode step's
    cmp = _kernel_vs_plain(params, cfg, prompts[0], device)
    rec["kernel_vs_plain_batch1"] = cmp
    rec["logit_rtol"] = SERVE_LOGIT_RTOL
    emit(rec)
    for tag, c in cmp.items():
        assert c["finite"] and c["rel"] <= SERVE_LOGIT_RTOL, (tag, c)
    del params
    torch.cuda.empty_cache()
    return rec


def phase_serve_f32(device) -> dict:
    """gemma2-27b at full width cut to 2 layers (local, global) in
    float32: greedy tokens of the kernel path = the plain path's."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = dataclasses.replace(get_config("gemma2-27b"), n_layers=2,
                              dtype="float32", use_pallas=True)
    assert T.layer_kinds(cfg) == ["local", "attn"]
    params = init_params(T.param_defs(cfg), 0, torch.float32, device=device)
    sv = ServeConfig(batch_slots=2, max_len=SERVE_MAX_LEN, eos_token=-1)
    prompts = _prompts(cfg.vocab, 4, *SERVE_PROMPT, seed=1)
    outs, launches = {}, {}
    for path, c in (("kernels", cfg),
                    ("plain", dataclasses.replace(cfg, use_pallas=False))):
        eng = ServingEngine(c, params, sv, device=device)
        calls = _timed(eng)
        reset_counts()
        outs[path] = eng.generate(prompts, max_new_tokens=8)
        launches[path] = counts()
        n_prefill, n_decode = len(calls["prefill"]), len(calls["decode"])
        del eng
        torch.cuda.empty_cache()
    cmp = _kernel_vs_plain(params, cfg, prompts[0], device)
    rec = {"phase": "serve_f32", "layers": cfg.n_layers, "requests": 4,
           "slots": 2, "new_tokens": 8, "tokens_equal":
           outs["kernels"] == outs["plain"], "tokens": outs["kernels"],
           "launches": launches, "kernel_vs_plain_batch1": cmp,
           "logit_rtol": SERVE_F32_LOGIT_RTOL}
    emit(rec)
    for tag, c in cmp.items():
        assert c["finite"] and c["rel"] <= SERVE_F32_LOGIT_RTOL, (tag, c)
    _expect(launches["kernels"], "serve_f32", flash=2 * n_prefill,
            decode=2 * n_decode)
    _expect(launches["plain"], "serve_f32 plain")
    assert rec["tokens_equal"], (outs["kernels"], outs["plain"])
    del params
    torch.cuda.empty_cache()
    return rec


def phase_card_vs_cpu(device) -> dict:
    """The gemma2 smoke config serves the same prompts on the card and
    on the CPU (the same float32 weights, made on the CPU): equal tokens,
    with EOS live so slots are refilled; then the launcher's --smoke run
    on the card."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = dataclasses.replace(get_smoke_config("gemma2-27b"),
                              use_pallas=True)
    host = init_params(T.param_defs(cfg), 0, device="cpu")
    card = _to(host, device)
    prompts = _prompts(cfg.vocab, 6, 18, 40, seed=2)
    probe = ServingEngine(cfg, host, ServeConfig(
        batch_slots=3, max_len=128, eos_token=-1), device="cpu")
    eos = probe.generate(prompts, max_new_tokens=3)[0][2]
    sv = ServeConfig(batch_slots=3, max_len=128, eos_token=eos)
    cpu_eng = ServingEngine(cfg, host, sv, device="cpu")
    cpu_out = cpu_eng.generate(prompts, max_new_tokens=10)
    eng = ServingEngine(cfg, card, sv, device=device)
    calls = _timed(eng)
    reset_counts()
    card_out = eng.generate(prompts, max_new_tokens=10)
    launches = counts()
    reset_counts()
    launcher.main(["--arch", "gemma2-27b", "--smoke"])
    launcher_launches = counts()
    rec = {"phase": "card_vs_cpu", "config": "gemma2-27b smoke",
           "tokens_equal": card_out == cpu_out, "stats": eng.stats,
           "cpu_stats": cpu_eng.stats, "launches": launches,
           "launcher_launches": launcher_launches}
    emit(rec)
    assert rec["tokens_equal"], (card_out, cpu_out)
    assert eng.stats == cpu_eng.stats and eng.stats["refills"] >= 1, rec
    _expect(launches, "card_vs_cpu", flash=cfg.n_layers * len(
        calls["prefill"]), decode=cfg.n_layers * len(calls["decode"]))
    assert launcher_launches["flash_attention"] > 0 and \
        launcher_launches["decode_attention"] > 0, launcher_launches
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # float32 products in full float32 (the port's parity contract)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    phase_build()
    kern = phase_kernels(device)
    seg = phase_segment_reduce(device)
    phase_paper(device)
    phase_golden(device)
    dc = phase_dc(device)
    for name, row in kern.items():
        row["launches"] = dc["launches"][name]
    _, mstep, mblock = phase_mega(device, dc)
    hot = phase_hotspot(device)
    seg["launches"] = hot["segment_sum"]["launches"]["segment_reduce"]
    attn = phase_attention(device)
    serve = phase_serve(device, attn["decode_attention"]["ms"] * 1e3)
    for name, row in attn.items():
        row["launches"] = serve["launches"][name]
    phase_serve_f32(device)
    phase_card_vs_cpu(device)
    rows = list(kern.values()) + [seg, mstep, mblock,
                                  attn["flash_attention"],
                                  attn["decode_attention"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
