#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):
  1. device  — the card, as ``nvidia-smi`` reports it;
  2. build   — ``nvcc`` builds every CUDA source of the port, in parallel;
  3. kernels — each per-flow CC kernel against its plain PyTorch version
               on the card at the main-path shape (R=36 runs x F=4096
               flows), at F in {1, 127, 129, 8193}, at n = R * F of every
               residue mod 4 and at a view 4 bytes past a 16-byte
               boundary: bitwise equal; swift's record adds the card's
               floor for one launch at its grid (an empty kernel, a
               three-in two-out copy); ``segment_reduce`` likewise at the
               DC walk (C = 1, 2, 3), the hotspot's three walks (C = 3,
               3, 2), a skewed CSR, a channel count for the row walk and
               the edge shapes, and timed on the DC walk and each hotspot
               walk beside the row walk (one thread a segment and channel),
               ``torch.segment_reduce``, ``index_select`` of the walk and
               its bound's bytes and chain terms (the chain from the
               card's measured dependent-add latency); kernel / plain /
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
               dragonfly.  A 100-step window runs on the card and on the
               CPU (plain versions) and must agree; then 2000 steps on
               the card give steps/s and peak device memory;
  7. mega    — the dc batch through the megakernel: 100 ``megastep``
               launches held StepTrace by StepTrace to the flow tier
               (timed by CUDA-graph replay), ``megastep_block`` at F in
               {1, 127, 129, 8193} and on the routing grid with two VCs a
               wire, then the 2000-step dc sweep as one launch per trace
               window, bitwise equal to phase 6's result, with its
               steps/s and profile; every mega path (here and in phases
               4, 5 and 8) prints its cluster size and the SMs it used;
  8. hotspot — half of 4096 flows into one host of the same dragonfly:
               too skewed for the dense walk, so the segment sum runs on
               the ``segment_reduce`` kernel; with ``reduce="pallas"``,
               through the megakernel and on the CPU it must agree
               bitwise;
  9. capture — every ``Sweep.run`` above goes through ``SWEEP_EXEC_CACHE``
               (one CUDA graph a trace window, replayed); here each cell
               (paper, golden routing, pathology, dc, hotspot fused and
               pallas) on the flow and mega tiers is held bitwise to its
               eager run (``Sweep.prepare`` + the uncaptured
               ``decimating_scan``), with steps/s both ways, the cache's
               misses, hits and build seconds, each kernel's launches
               equal both ways, the captured window's idle share and the
               bytes the entries hold; the paper batch with another
               ``dcqcn.kmin`` is a structural hit, bitwise equal to its
               eager run; the cache is cleared before serving;
 10. whatif  — the what-if query service (``repro_torch.serve.whatif``)
               on the card: benchmarks/serve_bench.py's replay (96
               queries of 4 CC stacks x incast 4/6/7, width 8): one
               capture, queries/s, latency p50/p99, each (workload, CC
               stack) bitwise equal to a standalone card ``Sweep.run``,
               the fake-clock burst probe (16 -> 4 admitted, 12
               throttled); then 8 of the dc cell's combinations (2 a
               reaction) as queries, on the flow and the megakernel tier,
               through ``auto_drain`` and, one batch, down the fleet road,
               each answer bitwise equal to its run in phase 6;
 11. fleet   — the dc sweep through ``run_fleet`` (2 worker threads, 4
               streamed shards, a journal): merged bitwise equal to phase
               6, one capture, peak memory beside phase 6's, the overhead
               against its wall; a plan at phase 6's check depth killed
               after 2 shards and resumed, bitwise;
 12. pacer   — ``erp_chunk_schedule`` of examples/paced_collectives.py's
               tree for PFC_ONLY, DCQCN and DCQCN_REV on the card (every CC
               kernel once a step) against the same schedule on the CPU
               (child processes) at the golden tolerance;
 13. attention — ``flash_attention`` (both routes: the tensor-core
               kernel for bf16 at d 64/128, the CUDA-core kernel for
               float32 and other widths; each call asserts its route) and
               ``decode_attention`` against their plain versions (3e-5
               float32, 2e-2 bfloat16) at gemma2-27b's serving shapes, at
               the edge shapes of tests/test_kernels.py, where every kv
               tile is skipped, where the softcap bites and (decode) at
               the edges of its tiling (d 8-256, GQA groups 1-8, a cache
               no multiple of the tile, a whole tile or batch row
               invalid), and at phase 17's shapes (flash at a 4-token
               prompt, shorter than one tile; internvl2's 48/8 heads);
               kernel / plain / bound time (with the SFU term
               beside the tensor bound; decode by CUDA-graph replay, two
               launches bitwise equal), flex_attention at softcap 50 and
               ``scaled_dot_product_attention`` at softcap 0; the
               CUDA-core route timed at serve_f32's float32 prefill
               (global and local layer, flex and SDPA beside it, two
               launches bitwise equal) and at recurrentgemma-9b's bf16
               local attention (d 256); the largest error of each route
               and dtype;
 14. serve   — gemma2-27b at full width and depth in bfloat16 (random
               weights from seed 0 on the card): 8 ragged prompts of
               4100-4200 tokens on 4 slots, 16 new tokens each, through
               ``ServingEngine.generate`` (its decode step captured once
               as a CUDA graph); exact launch counts (46 a prefill, all on
               the tensor-core route, 46 a decode step), time to first
               token, prefill and decode tokens/s, peak memory; the same
               tokens from an eager ``decode_step`` loop, with its decode
               step ms; one prefill call and 5 decode steps profiled
               (captured and eager wall, busy ms, idle share); then at
               batch 1 the prefill and first decode logits against the
               plain path;
 15. serve_f32 — gemma2-27b at full width cut to 2 layers (one local, one
               global) in float32: greedy tokens equal to the plain path,
               every flash launch on the CUDA-core route, one capture an
               engine; time to first token and seconds a prefill call on
               both paths;
 16. serve_families — the RG-LRU, SSM and MoE families in bfloat16
               (random weights from seed 0): first the attention shapes
               they bring, each held against its plain version and timed
               beside its bound, SDPA and (decode at g 16 / d 256 and g 1
               / d 128) flex_attention; then recurrentgemma-9b,
               falcon-mamba-7b and deepseek-moe-16b at full width and
               depth, and mixtral-8x22b at full width cut to 2 layers,
               one after the other, each freed before the next: 4
               requests of 1950-2048 tokens on 2 slots (each wave's
               longest 2048), 16 new tokens, through
               ``ServingEngine.generate`` (one decode capture each),
               exact launches by route, TTFT, prefill and decode tok/s,
               peak memory; the same tokens from an eager loop; one
               prefill with CUDA events around each mixer, flash call and
               associative scan, a prefill and an eager decode step
               profiled; at batch 1 the prefill and first decode logits
               against the plain path (where there is attention); the
               attention shapes include phase 17's (whisper-base's and
               internvl2-26b's flash and decode);
 17. serve_encdec_vlm — whisper-base (full size, bf16: 4 clips of stub
               frames from ``input_specs``, the 4-token SOT prompt, 64
               new tokens, a 448-slot cache) through
               ``encdec.prefill`` / ``decode_step``, and internvl2-26b
               (full width and depth, 39.84 GB: 2 requests of 1024 stub
               patches + 1024 tokens, 16 new, a 2176-slot cache) through
               ``vlm.prefill`` / ``transformer.decode_step``: prefill s
               over two calls, greedy decode eager and from one
               ``CapturedGraph`` capture (equal tokens), exact launches
               by route (6 / 48 flash a prefill call, the encoder and
               cross-attention none; 6 / 48 decode a step), peak memory,
               a profiled prefill call and 3 eager steps, the kernel
               path's batch-1 logits within 5% of the plain path's; then
               whisper-base in float32: greedy tokens equal to the plain
               path's (CUDA-core route), logits within 1e-4;
 18. card_vs_cpu — the gemma2 smoke config serves the same prompts on the
               card and on the CPU: equal tokens (CUDA-core route); the
               serving launcher's ``--smoke`` run on the card; the same
               for the four families' smoke configs (both MoE dispatches,
               both SSM scan branches, refills of recurrent state) and
               the launcher's ``--smoke`` run of recurrentgemma-9b; then
               whisper-base's and internvl2-26b's smoke configs through
               their prefill and a greedy decode loop (captured on the
               card): equal tokens, prefill logits within 1e-4;
 19. tune    — the autotuning path (``repro_torch.tune``): the paper sweep
               at temperature 0 bitwise the default run (a cache hit, the
               same launches); the soft model at tau 0.2 on the card within
               2e-3 of the CPU, and the kernel tiers refusing it;
               ``value_and_grad`` on paper-default DCQCN at the 8-sender
               incast, 1500 steps: twice bitwise, against the CPU (value
               2e-3, gradient cosine 0.99), gen_np / rp / segment_reduce
               launched at their exact counts in the forward and nothing in
               the backward, forward and backward ms a step, peak memory,
               idle share; each kernel's autograd rule bitwise equal to
               its plain version's gradient; ``autotune`` by ES at
               benchmarks/tune_bench.py's ES_KW (improved, one capture a
               population shape) and by gradient at the acceptance
               settings with iters cut to fit; a GradTuner killed after 2
               iterations and resumed bitwise equal to 4 straight;
 20. train   — the training path (``repro_torch.train``: data, AdamW,
               the chunked loss head, remat, the loop) under
               deterministic algorithms, attention on the plain path (the
               kernels have no backward); (b)-(e), untimed, run while the
               tune phase waits on its host-bound children, (a) last, on
               a quiet card: (a) starcoder2-3b at full width
               cut to 16 of 30 layers (bf16 params, f32 master, remat
               full, the head in 256-position chunks, 8 x 1024 zipf
               tokens), 4 steps through ``train_loop``: losses and grad
               norms finite, ms a step, tokens/s, the model FLOP rate and
               its share of the bf16 peak, the optimizer's share, peak
               memory, no kernel launched, one more step profiled (idle
               share); (b) the same width at depth 2: loss and gradients
               under remat none / full / dots bitwise equal, two 3-step
               runs from one seed bitwise equal; (c) starcoder2's smoke
               config in float32 with microbatches 2 and int8 + EF
               compression, 5 steps on the card and on the CPU, within
               ``TRAIN_CVC_*``; (d) examples/quickstart.py's model on the
               card: a run resumed from its step-10 checkpoint, and one
               resumed after a ``stop_flag`` save, bitwise the
               uninterrupted 20 steps; the launcher (``python -m
               repro_torch.launch.train --smoke``) resumed in a child
               process, its step-20 checkpoint bitwise the uninterrupted
               run's; (e) a loss with ``use_pallas=True`` under autograd
               raises (no launch), without autograd it equals the plain
               path's, and the plain path gives every leaf a gradient;
 21. sharded_sweep — the distribution substrate (``repro_torch.dist``):
               (a) a child process with a world of one on the card runs
               the dc sweep (36 runs, 2000 steps) through
               ``Sweep.run(mesh=sweep_mesh(1))`` on the flow and mega
               tiers, bitwise one launch of it timed there and phase 6's
               result, then the mega tier in a world of one over NCCL
               (the gather on the card), bitwise phase 6's result too;
               (b) two child processes share the card over gloo
               (both on cuda:0), 18 runs a rank, flow and mega, bitwise
               phase 6's result in both ranks, then the reference's
               two-device case (the paper incast, 3 runs padded to 4)
               bitwise its one launch; each prints its wall time against
               one launch, the gather's seconds, peak memory and launches
               a rank; (c) ``pipeline_apply`` of four 1024 x 1024 stages
               over 8 microbatches of 64 rows, bitwise the stages back to
               back on the card and within 1e-5 of the CPU; (d) the
               starcoder2 smoke config's float32 train state restored
               through ``train_loop(state_shardings=)`` onto
               ``logical_sharding`` of ``train_state_specs`` on
               ``make_host_mesh()``: placements as asked, values, the next
               step's loss and state bitwise the unsharded resume's.  (c)
               and (d) run in a child beside the tune phase's wait; (a)
               and (b) in children that start beside it and wait on
               stdin to touch the card, then run, (b) after (a), while
               the tune phase waits on its last child (the gradient
               autotune, one host-bound process), before phase 20 (a).
 22. sharded_models — the models' ``shard(...)`` calls, the dry run and
               the perf driver (``repro_torch.launch.{dryrun,perf}``):
               (a) two host children with no card, started after the
               build, run ``python -m repro_torch.launch.dryrun``'s
               ``main`` on the reference test's seven (arch, shape) pairs
               at full size, one child a production mesh (fake worlds of
               256 and 512 ranks), and the perf driver's ``main`` on one
               cell with one ``--set``; every cell traced, each rank's
               argument bytes the sharding rules' reckoning of every
               leaf's shard, the perf record written, a line a cell
               (FLOPs, collective bytes, temp GiB, fits_h100, trace s);
               the pod child also counts (b)'s two calls on fake tensors
               for the perf model; (b) phi3-medium-14b at full width and
               depth in bf16 in a world of one over NCCL: 2 x 2048 random
               tokens, a prefill and 8 eager greedy decode steps, then one
               train step at depth 2 on 4 x 1024 tokens, each inside
               ``set_mesh(make_host_mesh())`` (every leaf a DTensor, the
               ``shard`` calls live) and outside any mesh: logits, tokens,
               loss and new params bitwise, no kernel launched, device ms
               and host wall each way, peak memory, the perf model's
               compute and memory terms beside the device time.  Two
               ranks sharing the card over gloo are left out: gloo's
               all-gather of CUDA tensors kills both ranks (SIGSEGV,
               torch 2.11), so that check waits for a call with two
               cards (ROADMAP).
Kernel launch counts are zeroed just before each path's run and read
just after; every path asserts each of its kernels' exact count, and
flash_attention's exact count on each route.
Then the ``kernels`` summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.

Needs one CUDA card; without one (or without the rest of the repo next
to this file) it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
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
#: special-function (ex2, tanh) results a clock per SM on Hopper
SFU_PER_CLOCK = 16

#: steps of the DC-scale run (and of the what-if dc queries and the
#: fleet's dc run, held to it), and of its card-vs-CPU window (the
#: megastep comparison and the fleet's preempted plan share it): 2000
#: and 100, cut from 5000 and 200 (5000 -> 3000 with the families' serve
#: cells, 3000 -> 2000 with the sharded model step) to keep the script
#: under 600 s
DC_STEPS = 2000
DC_CHECK_STEPS = 100
#: steps of the hotspot runs (card engines and the CPU window)
HOT_STEPS = 200
#: the megakernel tier's Sweep options
MEGA = {"use_kernels": "mega"}

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


#: the whole script's time budget (half the driver's 1200 s limit); the
#: total line states the time against it
BUDGET_S = 600

#: the script's start: every phase line carries its seconds since
_T0 = time.perf_counter()


#: (phase, at_s) of every phase line printed, for the total line
_EMITTED: list = []


def emit(obj) -> None:
    at = time.perf_counter() - _T0
    if "phase" in obj:
        _EMITTED.append((obj["phase"], at))
    print(json.dumps({**obj, "at_s": at}), flush=True)


def _phase_seconds() -> dict:
    """Seconds from each phase line back to the line before it, summed
    by phase name: where the script's wall went."""
    out, prev = {}, 0.0
    for name, at in _EMITTED:
        out[name] = out.get(name, 0.0) + at - prev
        prev = at
    return out


def _kmod(name: str):
    """The port's module ``repro_torch.kernels.<name>`` (the package binds
    the attention functions, not their modules, under those names)."""
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")


def _kernel_modules():
    return tuple(_kmod(n) for n in ("cc_step", "fluid_reduce", "fluid_step",
                                    "flash_attention", "decode_attention"))


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


def routes() -> dict:
    """flash_attention's launches by route since ``reset_counts``."""
    return dict(_kmod("flash_attention").ROUTES)


def _expect_routes(got: dict, where: str, *, tensor_core: int = 0,
                   cuda_core: int = 0):
    """Exactly these flash_attention launches on each route."""
    want = {"tensor_core": tensor_core, "cuda_core": cuda_core}
    assert got == want, (where, got, want)


def plans() -> dict:
    """decode_attention's launches by plan kernel since ``reset_counts``."""
    return dict(_kmod("decode_attention").PLANS)


def _expect_plans(got: dict, where: str, *, split: int = 0,
                  group: int = 0):
    """Exactly these decode_attention launches on each kernel."""
    want = {"split": split, "group": group}
    assert got == want, (where, got, want)


def _decode(q, k, v, valid, **kw):
    """One ``decode_attention`` call, asserting it took the kernel
    ``decode_plan`` names for the shape (one launch there)."""
    DA = _kmod("decode_attention")
    before = dict(DA.PLANS)
    out = DA.decode_attention(q, k, v, valid, **kw)
    b, h, d = q.shape
    kern = DA.decode_plan(b, k.shape[1], h, k.shape[2], d, q.dtype).kernel
    moved = {r: n - before[r] for r, n in DA.PLANS.items() if n != before[r]}
    assert moved == {kern: 1}, (tuple(q.shape), q.dtype, moved, kern)
    return out


def _flash(q, k, v, **kw):
    """One ``flash_attention`` call, asserting it took the route
    ``_route`` names for q's dtype and head_dim (one launch there)."""
    FA = _kmod("flash_attention")
    before = dict(FA.ROUTES)
    out = FA.flash_attention(q, k, v, **kw)
    route = FA._route(q.dtype, q.shape[-1])
    moved = {r: n - before[r] for r, n in FA.ROUTES.items() if n != before[r]}
    assert moved == {route: 1}, (tuple(q.shape), q.dtype, moved, route)
    return out


def _launches_once_a_step(launches: dict, n_steps: int, where: str):
    """Each CC kernel of the flow path launched exactly once a step (the
    dense walk sums the queues: no segment_reduce, no megakernel)."""
    _expect(launches, where, cc=n_steps)


def _geometry(entry: str, runs: int) -> dict:
    """The megakernel's launch geometry on the last ``entry`` launch:
    cluster size, SMs used (runs x cluster), shared memory a CTA and
    what it keeps there."""
    from repro_torch.kernels import fluid_step as FS
    geo = FS.GEOMETRY[entry]
    return {"cluster": geo.cluster, "sms_used": runs * geo.cluster,
            "smem_bytes": geo.smem_bytes, "push_rows": geo.push_rows,
            "stage_paths": geo.stage_paths}


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
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

def _kernel_inputs(name: str, R: int, F: int, device, seed: int,
                   misaligned: bool = False):
    """(wrapper call, plain call) on random state of [R, F] flows;
    ``misaligned`` moves every state tensor to a view 4 bytes past a
    16-byte boundary (the kernels' scalar path)."""
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

    def shift(xs):
        if not misaligned:
            return xs
        out = []
        for x in xs:
            buf = torch.empty(x.numel() + 1, device=device)
            buf[1:] = x.reshape(-1)
            out.append(buf[1:].view(x.shape))
        return type(xs)(*out) if hasattr(xs, "_fields") else out
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
        xs = shift(xs)
        t_sec = u(0, 3e-3)[:, 0].contiguous()
        kw = dict(t_sec=t_sec, dt=dt)
        return (lambda: K.gen_np_step(*xs, **kw),
                lambda: K.gen_np_plain(*xs, K.pack_gen_np_params(t_sec, dt)))
    if name == "rp_step":
        from repro_torch.kernels.ref import RPState
        st = RPState(u(1e6, 12.5e9), u(1e6, 12.5e9), u(0, 1), u(0, 1.2e7),
                     u(0, 6e-5), u(0, 6e-5),
                     torch.floor(u(0, 9)), torch.floor(u(0, 9)))
        st, (cnp,) = shift(st), shift([bern(0.3)])
        return (lambda: K.rp_step(st, cnp, packed=rows["rp"]),
                lambda: K.rp_plain(st, cnp, rows["rp"]))
    if name == "erp_step":
        xs = [u(1e6, 12.5e9), u(0, 6e-5) * bern(0.5), bern(0.3),
              u(1e6, 12.5e9), u(2.5e12, 7.5e12)]
        xs = shift(xs)
        return (lambda: K.erp_step(*xs, packed=rows["erp"]),
                lambda: K.erp_plain(*xs, rows["erp"]))
    xs = shift([u(1e6, 12.5e9), u(0, 5e-5) * bern(0.5), u(0, 1e-5)])
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


#: (R, F) batches each CC kernel is held at: the main path, F straddling
#: the block sizes, and n = R * F at every residue mod 4 (swift's four
#: flows a thread); "36x4096_misaligned" repeats the main path 4 bytes
#: past a 16-byte boundary
CC_CASES = [(36, 4096), (1, 1), (3, 127), (3, 129), (2, 8193), (1, 4097),
            (1, 4098), (1, 4099)]


def _swift_floor(K, n: int, device) -> dict:
    """The card's floor for one launch at swift's grid: an empty kernel,
    and a kernel that reads three and writes two [n] float32 arrays,
    timed by the same CUDA-graph replay as the kernel."""
    import torch
    lib = K._lib()
    a, b, c, x, y = (torch.rand(n, device=device) for _ in range(5))

    def check(err):
        if err != 0:
            raise RuntimeError(lib.cc_error_string(err).decode())

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    floor_ms, _ = _time_ms(lambda: check(lib.cc_swift_floor(n, stream())))
    copy_ms, _ = _time_ms(lambda: check(lib.cc_swift_copy(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(),
        y.data_ptr(), n, stream())))
    torch.cuda.synchronize()
    assert torch.equal(x, a) and torch.equal(y, b + c)
    return {"launch_floor_us": floor_ms * 1e3, "copy_us": copy_ms * 1e3}


def phase_kernels(device) -> dict:
    """Every kernel bitwise against its plain version; timings at the
    main-path shape.  Launches made here are not counted by phase 6."""
    import torch
    from repro_torch.kernels import cc_step as K
    t0 = time.perf_counter()
    out = {}
    for name, (replaces, ops) in KERNELS.items():
        errs = {}
        for (R, F), mis in [(c, False) for c in CC_CASES] + [((36, 4096),
                                                              True)]:
            kern, plain = _kernel_inputs(name, R, F, device, seed=R * F,
                                         misaligned=mis)
            err = _max_abs_err(kern(), plain())
            torch.cuda.synchronize()
            tag = f"{R}x{F}" + ("_misaligned" if mis else "")
            errs[tag] = err
            if err != 0.0:
                raise AssertionError(
                    f"{name} differs from its plain version at {tag}: "
                    f"max |diff| = {err}")
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
        rec = {"phase": "kernels", "kernel": name, "shape": [36, 4096],
               "bitwise_equal": errs, "us": ms * 1e3,
               "plain_us": plain_ms * 1e3,
               "bound_us": max(b_ms, o_ms) * 1e3,
               "eager_us": eager_ms * 1e3,
               "plain_eager_us": plain_eager_ms * 1e3,
               "bytes": K.BYTES_PER_FLOW[name] * n}
        if name == "swift_step":
            floors = _swift_floor(K, n, device)
            rec.update(floors)
            out[name].update(floors)
        emit(rec)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})
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


def _vc2_sweep():
    """The golden routing scenes (K = 4 min/valiant/UGAL paths) with two
    VCs a wire: the three schemes' stages x the three routings."""
    from repro_torch.core import CCSpec, Sweep
    from repro_torch.core.params import LinkParams
    scen = _routing_scenes()
    stages = {"PFC_ONLY": ("cp", "np", "pfc"), "DCQCN": ("cp", "np", "rp"),
              "DCQCN_REV": ("ecp", "enp", "erp")}
    cfgs = {f"{s}/{r}": CCSpec(marking=m, notification=n, reaction=x,
                               routing=r, link=LinkParams(n_vcs=2))
            for s, (m, n, x) in stages.items()
            for r in ("min", "valiant", "ugal")}
    return Sweep.grid(configs=cfgs, scenarios=scen)


#: channels of the hotspot step's three walks over its one CSR (the
#: link sums of core/fluid.py: B and the two rate sums, then the marks)
HOT_WALK_CHANNELS = (3, 3, 2)
#: dependent adds timed for the chain term's per-add latency
FADD_CHAIN = 1 << 16


def _walk(off):
    """(longest segment, its rows) of CSR ``off``."""
    lens = off[1:] - off[:-1]
    return int(lens.max()), lens


def _skewed_csr(device, g):
    """One 5000-row segment among 10,000 short ones (0-40 rows), walked
    through a random gather: the one_segment shape beside short work."""
    import torch
    lens = torch.randint(0, 41, (10001,), generator=g, device=device)
    lens[3000] = 5000
    off = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    n = int(off[-1])
    rows = torch.randperm(n, generator=g, device=device)
    return off, rows, n


def _seg_cases(device):
    """(tag, data, rows, offsets) of segment_reduce: the fluid step's
    walks (its CSR over the real queues) at the DC batch (C = 1, 2, 3),
    at F in {1, 127, 129, 8193} and the hotspot's three walks (C = 3, 3,
    2 over one CSR), plus the edge shapes, a skewed CSR and a channel
    count the staged kernel is not built for (the row walk)."""
    import torch
    from repro_torch.kernels.fluid_reduce import csr_offsets
    g = torch.Generator(device=device).manual_seed(12)
    cases = []
    for tag, sweep in [("dc", _dc_sweep()), ("hot", _hotspot_sweep())] + [
            (f"F{F}", _flows_sweep(F)) for F in (1, 127, 129, 8193)]:
        stg = sweep.prepare(1, device=device)
        plan, n = stg.plan, stg.sd.alt_routes.numel()     # R*F*K*H rows
        chans = {"dc": (1, 2, 3), "hot": HOT_WALK_CHANNELS}.get(tag, (3,))
        for w, C in enumerate(chans):
            data = torch.randn((n, C), generator=g, device=device)
            name = f"{tag}{w}_C{C}" if tag == "hot" else f"{tag}_C{C}"
            walk = plan.seg_rows[:int(plan.seg_off[-1])]  # the read rows
            cases.append((name, data, walk, plan.seg_off))
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
    off, rows, n = _skewed_csr(device, g)
    for C in (1, 3):
        cases.append((f"skewed_C{C}", torch.randn((n, C), generator=g,
                                                  device=device), rows, off))
    cases.append(("rowwalk_C5", torch.randn((n, 5), generator=g,
                                            device=device), rows, off))
    return cases


def _fadd_clocks(device) -> float:
    """Clocks of one dependent __fadd_rn on this card: one thread adds
    FADD_CHAIN values in a chain between two clock64 reads (the least
    time a segment's sum can take is its length times this)."""
    import torch
    from repro_torch.kernels import fluid_reduce as FR
    lib = FR._lib()
    x = torch.tensor([1.0, 1e-7], device=device)
    clocks = torch.zeros(1, dtype=torch.int64, device=device)
    total = torch.zeros(1, device=device)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):                   # the first call warms the clock
        err = lib.fr_fadd_clocks(x.data_ptr(), FADD_CHAIN, clocks.data_ptr(),
                                 total.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(lib.fr_error_string(err).decode())
    torch.cuda.synchronize()
    return int(clocks) / FADD_CHAIN


def _time_walk(tag, data, rows, off, clock_mhz: float,
               fadd_clocks: float) -> dict:
    """One walk timed: the staged kernel (its schedule passed, as the
    fluid step does) and the row walk by CUDA-graph replay, the plain
    version and torch.segment_reduce by events; the bound's bytes and
    chain terms.  Beside them, what the random gather alone costs: the
    32-byte sectors the walk's data rows span (``sector_bytes``, with the
    indices, offsets and output), ``torch.index_select`` of the walk
    (``gather_us``) and the kernel over the walk already gathered into
    order (``sorted_us``), both by graph replay."""
    import torch
    from repro_torch.kernels import fluid_reduce as FR
    S, C = off.shape[0] - 1, data.shape[1]
    M = rows.shape[0]
    sched = FR.reduce_schedule(off)
    run = lambda: FR.segment_reduce(data, None, S, rows=rows,  # noqa: E731
                                    offsets=off, schedule=sched)
    srt = data[rows]
    longest, lengths = _walk(off)
    lib = torch.segment_reduce(srt, "sum", lengths=lengths, axis=0)
    lib_same = bool(torch.equal(lib, run()))
    ms, eager_ms = _time_ms(run)
    rowwalk_ms, _ = _time_ms(lambda: FR.segment_reduce_rowwalk(data, off,
                                                               rows))
    gather_ms, _ = _time_ms(lambda: torch.index_select(data, 0, rows))
    sorted_ms, _ = _time_ms(lambda: FR.segment_reduce(
        srt, None, S, offsets=off, schedule=sched))
    first = rows * (4 * C)
    sectors = int(((first + 4 * C - 1) // 32 - first // 32 + 1).sum())
    # the plain version reads its walk length on the host: not capturable
    plain_ms = _event_ms(lambda: FR.segment_reduce_plain(data, off, rows),
                         n=10 if longest < 500 else 2)
    # torch.segment_reduce syncs with the host: not capturable either
    library_ms = _event_ms(lambda: torch.segment_reduce(
        srt, "sum", lengths=lengths, axis=0))
    nbytes = 4 * M * C + 8 * M + 8 * (S + 1) + 4 * S * C
    sector_bytes = nbytes - 4 * M * C + 32 * sectors
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = M * C / FP32_FLOPS * 1e3
    chain_ms = longest * fadd_clocks / (clock_mhz * 1e6) * 1e3
    return {"walk": tag, "shape": [M, C, S], "longest_segment": longest,
            "items": int(sched.items.shape[0]), "long_items": sched.n_long,
            "us": ms * 1e3, "eager_us": eager_ms * 1e3,
            "rowwalk_us": rowwalk_ms * 1e3, "gather_us": gather_ms * 1e3,
            "sorted_us": sorted_ms * 1e3, "plain_us": plain_ms * 1e3,
            "library_us": library_ms * 1e3, "library_bitwise_equal": lib_same,
            "bytes": nbytes, "bytes_bound_us": b_ms * 1e3,
            "sector_bytes": sector_bytes,
            "sector_bound_us": sector_bytes / HBM_BYTES_PER_S * 1e6,
            "ops_bound_us": o_ms * 1e3, "chain_bound_us": chain_ms * 1e3,
            "bound_us": max(b_ms, o_ms, chain_ms) * 1e3,
            "of_bound": max(b_ms, o_ms, chain_ms) / ms,
            "clock_mhz": clock_mhz, "fadd_clocks": fadd_clocks}


def phase_segment_reduce(device) -> dict:
    """segment_reduce bitwise against its plain version at every case;
    timed at the DC walk and at each hotspot walk (the path that
    launches it), beside the row walk, its plain version and
    torch.segment_reduce.  The kernels row takes the first hotspot walk."""
    import torch
    from repro_torch.kernels import fluid_reduce as FR
    t0 = time.perf_counter()
    errs, walks = {}, {}
    for tag, data, rows, off in _seg_cases(device):
        S = off.shape[0] - 1
        got = FR.segment_reduce(data, None, S, rows=rows, offsets=off)
        want = FR.segment_reduce_plain(data, off, rows)
        torch.cuda.synchronize()
        errs[tag] = _max_abs_err([got], [want])
        if errs[tag] != 0.0:
            raise AssertionError(f"segment_reduce differs from its plain "
                                 f"version at {tag}: {errs[tag]}")
        if tag == "dc_C3" or tag.startswith("hot"):
            walks[tag] = (data, rows, off)
    emit({"phase": "kernels", "kernel": "segment_reduce",
          "bitwise_equal": errs})
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    fadd = _fadd_clocks(device)
    recs = {tag: _time_walk(tag, *w, clock_mhz, fadd)
            for tag, w in walks.items()}
    for rec in recs.values():
        emit({"phase": "kernels", "kernel": "segment_reduce", **rec})
    hot = recs["hot0_C3"]
    b_ms = max(hot["bytes_bound_us"], hot["ops_bound_us"]) / 1e3
    row = {"name": "segment_reduce", "route": "cuda",
           "source": WHOLE_STEP["segment_reduce"][0],
           "replaces": WHOLE_STEP["segment_reduce"][1], "launches": None,
           "max_abs_err": max(errs.values()), "ms": hot["us"] / 1e3,
           "plain_ms": hot["plain_us"] / 1e3, "bound_ms": b_ms,
           "bound_by": ("bytes" if hot["bytes_bound_us"]
                        >= hot["ops_bound_us"] else "operations"),
           "library_ms": hot["library_us"] / 1e3,
           "chain_ms": hot["chain_bound_us"] / 1e3, "walk": "hot0_C3"}
    emit({"phase": "segment_reduce", "seconds": time.perf_counter() - t0})
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

def _paper_sweep(kmin: float | None = None):
    """The paper's section II grid: 3 schemes x the incast scene (window
    and equal-work, both wirings); ``kmin`` moves every point's DCQCN
    marking threshold (the same structure, other data)."""
    import dataclasses
    from repro_torch.core import (CCScheme, PAPER_CONFIG, ScenarioSpec,
                                  Sweep)
    scen = {}
    for roll in (0, 1):
        scen[f"window{roll}"] = ScenarioSpec.paper_incast(roll=roll)
        scen[f"volume{roll}"] = ScenarioSpec.paper_incast_volume(roll=roll)
    cfgs = {s.name: PAPER_CONFIG.replace(scheme=s) for s in CCScheme}
    if kmin is not None:
        cfgs = {k: dataclasses.replace(c, dcqcn=dataclasses.replace(
            c.dcqcn, kmin=kmin)) for k, c in cfgs.items()}
    return Sweep.grid(configs=cfgs, scenarios=scen)


def phase_paper(device) -> dict:
    from repro_torch.core import CCScheme
    sweep = _paper_sweep()
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

def _routing_scenes() -> dict:
    """The two scenes of the golden routing grid (K = 4 paths)."""
    from repro_torch.core import ScenarioSpec
    from repro_torch.core.workloads import group_shift
    from repro_torch.net import FabricSpec
    dfly = FabricSpec.dragonfly(a=2, p=2, h=2)
    ft = FabricSpec.fat_tree(4, taper=2)
    return {"dfly_adv": group_shift(5, 4, t_stop=0.5e-3).spec(
                fabric=dfly, n_paths=4, route_seed=0, label="dfly_adv"),
            "ft_perm": ScenarioSpec.permutation(
                16, seed=2, fabric=ft, n_paths=4, route_seed=0,
                t_start=0.0, t_stop=0.5e-3, label="ft_perm")}


def _golden_routing():
    from repro_torch.core import CCScheme, PAPER_CONFIG, Sweep
    scen = _routing_scenes()
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
           "windows": len(res.times), "launches": launches,
           "geometry": _geometry("megastep_block", len(sweep.points))}
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

def _dc_spec():
    from repro_torch.core import ScenarioSpec
    from repro_torch.net import FabricSpec
    return ScenarioSpec.permutation(4096, seed=0,
                                    fabric=FabricSpec.dragonfly(4, 4, 4))


def _dc_sweep():
    from repro_torch.core import CCSpec, Sweep, cc
    cfgs = {f"{m}+{n}+{r}": CCSpec(marking=m, notification=n, reaction=r)
            for m in cc.MARKING.names() for n in cc.NOTIFICATION.names()
            for r in cc.REACTION.names()}
    return Sweep.grid(configs=cfgs, scenarios={"dfly272_f4096": _dc_spec()})


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
    rec["result"], rec["check_result"] = res, card
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
    entries = int(stg.plan.seg_off[-1])
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
    step_geo = _geometry("megastep", R)
    st0 = stm.state
    # device time: launches replayed from a CUDA graph (the wrapper's
    # host cost, ~0.3-0.5 ms a call, is out of it); the eager time
    # beside it; the plain version (the flow tier's step) is host-bound,
    # and this is what it costs
    step_ms, step_eager_ms = _time_ms(lambda: stm.step(st0), 20)
    plain_ms = _event_ms(lambda: stg.step(st0), 5)
    step_bound, step_by = _mega_bound(stm, 1, False)
    # megastep_block at ragged flow counts, and with two VCs a wire
    ragged = {}
    for nf in (1, 127, 129, 8193):
        sw = _flows_sweep(nf)
        a = sw.run(n_steps=200, trace_every=10, device=device)
        b = sw.run(n_steps=200, trace_every=10, device=device,
                   use_kernels="mega")
        same, abs_d, _ = _result_diff(b, a)
        ragged[nf] = {"bitwise_equal": same,
                      **_geometry("megastep_block", len(sw.points))}
        assert same, ("megastep_block", nf, abs_d)
    sw = _vc2_sweep()
    a = sw.run(n_steps=300, trace_every=10, device=device)
    reset_counts()
    b = sw.run(n_steps=300, trace_every=10, device=device,
               use_kernels="mega")
    same, abs_d, _ = _result_diff(b, a)
    vc2 = {"runs": len(sw.points), "steps": 300, "bitwise_equal": same,
           "launches": counts(),
           **_geometry("megastep_block", len(sw.points))}
    assert same, ("megastep_block V=2", abs_d)
    _expect(vc2["launches"], "mega V=2", block=30)
    # the dc sweep, one launch per trace window
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = sweep.run(n_steps=DC_STEPS, trace_every=100, device=device,
                    use_kernels="mega")
    wall = time.perf_counter() - t0
    block_launches = counts()
    block_geo = _geometry("megastep_block", R)
    peak = torch.cuda.max_memory_allocated()
    same, abs_d, _ = _result_diff(res, dc["result"])
    windows = DC_STEPS // 100
    # the sweep's host side: its prepare (stacking, CSR tables, the
    # megakernel's tables and geometry) as a share of the wall time
    t0 = time.perf_counter()
    sweep.prepare(DC_STEPS, trace_every=100, device=device,
                  use_kernels="mega")
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    stb = sweep.prepare(100, trace_every=100, device=device,
                        use_kernels="mega")
    block_ms = _event_ms(lambda: stb.block(stb.state), 3)
    block_plain_ms = _event_ms(
        lambda: [stg.step(st0) for _ in range(100)], 1)
    block_bound, block_by = _mega_bound(stb, 100, True)
    rec = {"phase": "mega", "runs": R, "flows": F,
           "megastep": {"steps": n, "bitwise_equal_flow_tier": True,
                        "launches": step_launches, "us": step_ms * 1e3,
                        "timed_by": "cuda graph replay",
                        "eager_us": step_eager_ms * 1e3,
                        "plain_us": plain_ms * 1e3,
                        "bound_us": step_bound * 1e3,
                        "geometry": step_geo},
           "megastep_block_ragged_bitwise": ragged,
           "megastep_block_vc2": vc2,
           "sweep": {"steps": DC_STEPS, "windows": windows, "wall_s": wall,
                     "steps_per_s": DC_STEPS / wall,
                     "run_steps_per_s": R * DC_STEPS / wall,
                     "flow_tier_steps_per_s": dc["steps_per_s"],
                     "max_memory_allocated": peak,
                     "bitwise_equal_flow_tier": same, "max_abs_diff": abs_d,
                     "launches": block_launches,
                     "prepare_s": prepare_s,
                     "window_us": block_ms * 1e3,
                     "plain_window_us": block_plain_ms * 1e3,
                     "bound_us": block_bound * 1e3,
                     "geometry": block_geo},
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
    reset_counts()
    runs["mega"] = sweep.run(n_steps=HOT_STEPS, trace_every=100,
                             device=device, use_kernels="mega")
    rec["mega"] = {"launches": counts(),
                   **_geometry("megastep_block", len(sweep.points))}
    _expect(rec["mega"]["launches"], "hotspot mega",
            block=HOT_STEPS // 100)
    t0 = time.perf_counter()
    runs["cpu"] = sweep.run(n_steps=HOT_STEPS, trace_every=100,
                            device="cpu")
    rec["cpu_wall_s"] = time.perf_counter() - t0
    rec["mega_bitwise_equal"] = _result_diff(runs["mega"],
                                             runs["segment_sum"])[0]
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
    assert rec["mega_bitwise_equal"], rec
    assert rec["delivered_gb"] > 0, rec
    return rec


# ---------------------------------------------------------------------------
# phase 9: every Sweep cell captured against its eager run
# ---------------------------------------------------------------------------

#: (cell, sweep builder, steps, trace_every, engines): each cell's
#: captured run against its eager run.  Steps are cut so the eager flow
#: tier (host-bound, 80-200 steps/s) takes a few seconds a cell; the
#: paper's flows open at 1 ms, so its cell runs 0.5 ms past that.  The
#: golden cells run half their files' steps (300 and 500), to keep the
#: script under 600 s with the families' serve cells.
CAPTURE_CELLS = [
    ("paper", lambda: _paper_sweep(), 1500, None, ({}, MEGA)),
    ("golden_routing", lambda: _golden_routing()[0], 300, None, ({}, MEGA)),
    ("pathology", lambda: _golden_pathology()[0], 500, None, ({}, MEGA)),
    ("dc", lambda: _dc_sweep(), 300, 100, ({}, MEGA)),
    ("hotspot", lambda: _hotspot_sweep(), 200, 100,
     ({}, MEGA, {"reduce": "pallas"})),
]


#: captured windows replayed under torch.profiler a cell (one: the dc
#: flow window's ~62,000 kernels make processing the trace the phase's
#: longest part)
CAPTURE_PROFILED_WINDOWS = 1


def _eager_run(sweep, n_steps, trace_every, device, **kw):
    """``sweep``'s run issued eagerly: ``Sweep.prepare`` and the
    uncaptured ``decimating_scan`` (the port's eager API)."""
    import torch
    from repro_torch.core.simulator import decimating_scan
    stg = sweep.prepare(n_steps, trace_every, device=device, **kw)
    final, tr = decimating_scan(stg.step, stg.state, stg.n_samples,
                                stg.trace_every,
                                float(sweep.points[0].cfg.sim.dt),
                                sweep.n_vcs, block_fn=stg.block)
    res = sweep.collect(final, tr, stg.trace_every)
    torch.cuda.synchronize()
    return res


def _replay_profile(entry, windows: int, events_only: bool) -> dict:
    """Device busy and idle share of ``windows`` back-to-back advances of
    a captured window (graph replays): kernel durations from
    torch.profiler, or the graph's span by CUDA events around each
    replay where the profiler sees no kernel inside the graph or
    (``events_only``: the mega tier) misses the megakernel there."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    entry.advance()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(windows):
            entry.advance()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    per, n_ops = _device_us(prof)
    rec = {"windows": windows, "profiled_wall_ms_per_window":
           pwall / windows * 1e3}
    by_profiler = bool(per) and not events_only
    if per:
        busy = sum(per.values()) / 1e6
        rec.update({"profiler_ops_per_window": n_ops / windows,
                    "profiler_busy_ms_per_window": busy / windows * 1e3,
                    "device_idle_share_profiled": 1.0 - busy / pwall})
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(windows)]
    t0 = time.perf_counter()
    for a, b in ev:
        a.record()
        entry.advance()
        b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    span = sum(a.elapsed_time(b) for a, b in ev) / 1e3
    rec.update({"device_timed_by": "torch.profiler" if by_profiler
                else "cuda events (the graph's span)",
                "wall_ms_per_window": wall / windows * 1e3,
                "graph_ms_per_window": span / windows * 1e3,
                "device_idle_share": 1.0 - (busy if by_profiler else span)
                / wall})
    return rec


def _cache_bytes() -> dict:
    """Device bytes the sweep cache's entries hold: their static tensors,
    and what clearing the cache gives back to the card (tensors and the
    graphs' pools, ``memory_reserved`` before and after).  Clears it."""
    import gc
    import torch
    from repro_torch.core import SWEEP_EXEC_CACHE
    entries = SWEEP_EXEC_CACHE.values()
    n, static = len(entries), sum(e.nbytes() for e in entries)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    SWEEP_EXEC_CACHE.clear()
    del entries
    gc.collect()
    torch.cuda.empty_cache()
    return {"entries": n, "static_bytes": static,
            "freed_bytes": before - torch.cuda.memory_reserved()}


def _capture_cell(sweep, n_steps, trace_every, device, kw) -> dict:
    """One cell on one engine: the captured run (a miss, then a hit)
    against the eager run, bitwise on every trace and final-state leaf,
    with steps/s both ways, the cache's counters and the launches, and
    the idle share of the captured window."""
    import torch
    from repro_torch.core import SWEEP_EXEC_CACHE
    reset_counts()
    t0 = time.perf_counter()
    eager = _eager_run(sweep, n_steps, trace_every, device, **kw)
    eager_s = time.perf_counter() - t0
    eager_launches = counts()
    s0 = SWEEP_EXEC_CACHE.stats()
    walls, same = [], []
    for _ in range(2):                       # the miss, then a hit
        reset_counts()
        t0 = time.perf_counter()
        res = sweep.run(n_steps, trace_every, device=device, **kw)
        walls.append(time.perf_counter() - t0)
        same.append(_result_diff(res, eager)[0])
        launches = counts()
        assert launches == eager_launches, (launches, eager_launches)
    d = SWEEP_EXEC_CACHE.stats() - s0
    entry = SWEEP_EXEC_CACHE.values()[-1]
    torch.cuda.synchronize()
    rec = {"engine": kw or {"use_kernels": False}, "steps": n_steps,
           "windows": len(eager.times), "runs": len(sweep.points),
           "bitwise_equal_eager": all(same), "eager_wall_s": eager_s,
           "eager_steps_per_s": n_steps / eager_s,
           "captured_miss_wall_s": walls[0],
           "captured_wall_s": walls[1],
           "captured_steps_per_s": n_steps / walls[1],
           "speedup": eager_s / walls[1], "cache": d.to_dict(),
           "capture_s": entry.capture_s, "launches": eager_launches,
           "entry_static_bytes": entry.nbytes(),
           "captured_window": _replay_profile(
               entry, CAPTURE_PROFILED_WINDOWS,
               events_only=kw.get("use_kernels") == "mega")}
    assert all(same), ("captured run differs from the eager run", rec)
    assert (d.misses, d.hits) == (1, 1), d
    return rec


def phase_capture(device) -> dict:
    """Each Sweep cell through SWEEP_EXEC_CACHE against its eager run on
    each engine; the paper batch with another ``dcqcn.kmin`` as a
    structural hit; then the device bytes the entries hold."""
    from repro_torch.core import SWEEP_EXEC_CACHE, config_grid
    t0 = time.perf_counter()
    # what the earlier phases' entries hold (the serve phases need ~67
    # GB of the card, so the phase ends with the cache cleared too)
    rec = {"phase": "capture", "earlier_phases_cache_bytes": _cache_bytes(),
           "cells": {}}
    for cell, build, n, k, engines in CAPTURE_CELLS:
        sweep = build()
        out = rec["cells"][cell] = {}
        for kw in engines:
            tag = kw.get("use_kernels") or kw.get("reduce") or "flow"
            out[tag] = _capture_cell(sweep, n, k, device, kw)
        out["cache_bytes"] = _cache_bytes()
    # a structural hit: the paper batch, every point's kmin moved
    paper = _paper_sweep()
    moved = _paper_sweep(kmin=8192.0)
    n = CAPTURE_CELLS[0][2]
    paper.run(n, device=device)
    s0 = SWEEP_EXEC_CACHE.stats()
    got = moved.run(n, device=device)
    d = SWEEP_EXEC_CACHE.stats() - s0
    want = _eager_run(moved, n, None, device)
    hit = {"cache": d.to_dict(), "bitwise_equal_eager":
           _result_diff(got, want)[0],
           "differs_from_default_kmin":
           not _result_diff(got, paper.run(n, device=device))[0]}
    rec["structural_hit"] = hit
    rec["cache_bytes"] = _cache_bytes()
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    assert (d.misses, d.hits) == (0, 1), d
    assert hit["bitwise_equal_eager"] and hit["differs_from_default_kmin"], hit
    return rec


# ---------------------------------------------------------------------------
# phase 10: the what-if query service
# ---------------------------------------------------------------------------

#: the reference's serve bench (benchmarks/serve_bench.py): 96 queries of
#: its 12-combination mix over 4 tenants, 400 steps, a drain every 24
WHATIF_QUERIES = 96
WHATIF_STEPS = 400
WHATIF_DRAIN_EVERY = 24
WHATIF_OPEN = dict(rate=1e9, burst=10_000, max_queue=256)
#: dc-scale queries: this many of the dc sweep's combinations a reaction
#: (8 queries, one batch of the engine's width; 4 a reaction, 16
#: queries, before phase 17 came)
WHATIF_DC_PER_REACTION = 2
#: fields of one point's SimResult held bitwise
SIM_FIELDS = ("times", "delivered", "rate", "inst_thr", "max_q",
              "n_paused", "marked", "cnp", "n_nonmin", "ctrl", "pause_time",
              "vc_stall")


def _serve_mix():
    """benchmarks/serve_bench.py's mix: (label, cfg, spec) of 4 CC stacks
    x 3 incast workloads, one flow bucket (8) on the default pod."""
    import dataclasses
    from repro_torch.core import CCSpec, ScenarioSpec
    cfgs = {
        "rev": CCSpec(),
        "dcqcn": CCSpec(marking="cp", notification="np", reaction="rp"),
        "swift": CCSpec(reaction="swift"),
        "rev-tuned": CCSpec().replace(rev=dataclasses.replace(
            CCSpec().rev, erp_settle=0.9)),
    }
    specs = {"in4": ScenarioSpec.incast(4), "in6": ScenarioSpec.incast(6),
             "in7": ScenarioSpec.incast(7)}
    return [(f"{cn}/{sn}", cfg, spec)
            for cn, cfg in cfgs.items() for sn, spec in specs.items()]


def _sim_same(a, b) -> bool:
    """Two one-point ``SimResult`` views bitwise equal: every trace field,
    the time base and every final-state leaf."""
    import numpy as np

    def same(x, y):
        if x is None or y is None:
            return x is None and y is None
        x, y = np.asarray(x), np.asarray(y)
        return x.shape == y.shape and np.array_equal(
            x, y, equal_nan=x.dtype.kind == "f")

    if not all(same(getattr(a, f), getattr(b, f)) for f in SIM_FIELDS):
        return False
    for f in a.final._fields:
        x, y = getattr(a.final, f), getattr(b.final, f)
        pairs = [(x[k], y[k]) for k in x] if isinstance(x, dict) else \
            [(x, y)]
        if not all(same(u, v) for u, v in pairs):
            return False
    return True


def _dc_queries():
    """``WHATIF_DC_PER_REACTION`` of the dc sweep's combinations for each
    reaction, as (point name, cfg): dc-scale what-if queries."""
    from repro_torch.core import cc
    by_reaction = {}
    for p in _dc_sweep().points:
        reaction = p.name.split("/")[0].split("+")[2]
        by_reaction.setdefault(reaction, []).append((p.name, p.cfg))
    return [q for r in cc.REACTION.names()
            for q in by_reaction[r][:WHATIF_DC_PER_REACTION]]


def _engine(device, *, auto_drain: bool = False, **cfg):
    from repro_torch.serve.whatif import (AdmissionConfig, CCQueryEngine,
                                          EngineConfig)
    return CCQueryEngine(EngineConfig(
        max_batch=8, admission=AdmissionConfig(**WHATIF_OPEN),
        device=device, **cfg), auto_drain=auto_drain)


def _ask_all(eng, queries) -> tuple[list, float]:
    """Submit ``queries``, drain, return (results in order, wall s)."""
    import torch
    from repro_torch.serve.whatif import Admitted
    t0 = time.perf_counter()
    tickets = []
    for q in queries:
        out = eng.submit(q)
        assert isinstance(out, Admitted), out
        tickets.append(out.ticket)
    eng.drain()
    torch.cuda.synchronize()
    return [eng.result(t) for t in tickets], time.perf_counter() - t0


def _serve_replay(device) -> dict:
    """The serve bench's replay on the card: one capture for the whole
    mix, the launches, latency and queries/s; one query per (workload,
    CC stack) bitwise equal to a standalone card ``Sweep.run`` of its
    point; the fake-clock burst probe."""
    import torch
    from repro_torch.core import Sweep
    from repro_torch.serve.whatif import (AdmissionConfig, Admitted,
                                          CCQueryEngine, EngineConfig,
                                          Throttled, WhatIfQuery)
    mix = _serve_mix()
    eng = _engine(device)
    reset_counts()
    t0 = time.perf_counter()
    first = {}
    for i in range(WHATIF_QUERIES):
        label, cfg, spec = mix[i % len(mix)]
        out = eng.submit(WhatIfQuery(cfg=cfg, scenario=spec,
                                     n_steps=WHATIF_STEPS, label=label,
                                     tenant=f"t{i % 4}"))
        assert isinstance(out, Admitted), out
        first.setdefault(label, out.ticket)
        if (i + 1) % WHATIF_DRAIN_EVERY == 0:
            eng.drain()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    m = eng.metrics()
    solo = {label: _sim_same(eng.result(first[label]).result, Sweep(
        [("p", cfg, spec)]).run(n_steps=WHATIF_STEPS, device=device)["p"])
            for label, cfg, spec in mix}
    clk = [0.0]
    probe = CCQueryEngine(EngineConfig(admission=AdmissionConfig(
        rate=10.0, burst=4, max_queue=8), device=device),
        clock=lambda: clk[0])
    burst = [probe.submit(WhatIfQuery(cfg=mix[0][1], scenario=mix[0][2],
                                      n_steps=WHATIF_STEPS))
             for _ in range(16)]
    rec = {"queries": WHATIF_QUERIES, "steps": WHATIF_STEPS,
           "wall_s": wall, "queries_per_s": WHATIF_QUERIES / wall,
           "batches": m["batches"], "mean_occupancy": m["mean_occupancy"],
           "cache": m["exec_cache"], "captures": m["exec_cache"]["misses"],
           "hit_rate": m["exec_cache"]["hit_rate"],
           "latency_s": m["latency_s"], "queue_wait_s": m["queue_wait_s"],
           "run_s": m["run_s"], "signatures": m["signatures"],
           "launches": launches,
           "bitwise_equal_standalone": solo,
           "throttle_probe": {
               "submitted": len(burst),
               "admitted": sum(isinstance(o, Admitted) for o in burst),
               "throttled": sum(isinstance(o, Throttled) for o in burst),
               "queue_full": probe.metrics()["admission"]["queue_full"]}}
    emit({"phase": "whatif", "check": "serve_mix", **rec})
    assert rec["captures"] == 1 and m["signatures"] == 1, rec["cache"]
    assert m["exec_cache"]["hits"] == m["batches"] - 1, rec["cache"]
    assert all(solo.values()), solo
    assert rec["throttle_probe"] == {"submitted": 16, "admitted": 4,
                                     "throttled": 12, "queue_full": 0}, rec
    _expect(launches, "whatif serve mix", cc=m["batches"] * WHATIF_STEPS,
            seg=3 * m["batches"] * WHATIF_STEPS)
    return rec


def phase_whatif(device, dc: dict) -> dict:
    """The what-if query service on the card: the serve bench's replay,
    then 8 dc-scale queries on the flow tier and the megakernel tier,
    through ``auto_drain`` and through the fleet road, each answer
    bitwise equal to its run in phase 6's dc sweep."""
    from repro_torch.core import SWEEP_EXEC_CACHE
    from repro_torch.serve.whatif import WhatIfQuery
    t_phase = time.perf_counter()
    rec = {"phase": "whatif", "serve_mix": _serve_replay(device)}
    want = dc["result"]
    spec = _dc_spec()
    queries = [WhatIfQuery(cfg=cfg, scenario=spec, n_steps=DC_STEPS,
                           trace_every=100, label=name)
               for name, cfg in _dc_queries()]
    names = [q.label for q in queries]
    n_batches = -(-len(queries) // 8)
    windows = DC_STEPS // 100
    answers = {}
    for tier, kw in (("flow", {}), ("mega", MEGA)):
        eng = _engine(device, **kw)
        reset_counts()
        got, wall = _ask_all(eng, queries)
        launches = counts()
        m = eng.metrics()
        answers[tier] = got
        row = {"queries": len(queries), "steps": DC_STEPS, "width": 8,
               "wall_s": wall, "queries_per_s": len(queries) / wall,
               "run_steps_per_s": len(queries) * DC_STEPS / wall,
               "cache": m["exec_cache"], "latency_s": m["latency_s"],
               "launches": launches,
               "bitwise_equal_dc": [_sim_same(r.result, want[n])
                                    for r, n in zip(got, names)]}
        if tier == "mega":
            row["geometry"] = _geometry("megastep_block", 8)
        rec[f"dc_{tier}"] = row
        emit({"phase": "whatif", "check": f"dc_{tier}", **row})
        assert all(row["bitwise_equal_dc"]), row["bitwise_equal_dc"]
        if tier == "mega":
            _expect(launches, "whatif dc mega", block=n_batches * windows)
        else:
            _expect(launches, "whatif dc flow", cc=n_batches * DC_STEPS,
                    seg=3 * n_batches * DC_STEPS)

    # the same queries through the background drain
    reset_counts()
    t0 = time.perf_counter()
    with _engine(device, auto_drain=True) as eng:
        tickets = [eng.submit(q).ticket for q in queries]
        got = [eng.wait(t, timeout=600) for t in tickets]
    wall = time.perf_counter() - t0
    row = {"wall_s": wall, "launches": counts(),
           "bitwise_equal_sync": [r is not None
                                  and _sim_same(r.result, s.result)
                                  for r, s in zip(got, answers["flow"])]}
    rec["dc_auto_drain"] = row
    emit({"phase": "whatif", "check": "dc_auto_drain", **row})
    assert all(row["bitwise_equal_sync"]), row

    # one batch down the fleet road (streamed shards of 4 on 2 workers)
    eng = _engine(device, fleet_threshold=0.0)
    reset_counts()
    got, wall = _ask_all(eng, queries[:8])
    row = {"queries": 8, "wall_s": wall, "launches": counts(),
           "via_fleet": [r.via_fleet for r in got],
           "cache": eng.metrics()["exec_cache"],
           "bitwise_equal_inline": [_sim_same(r.result, s.result) for r, s
                                    in zip(got, answers["flow"][:8])]}
    rec["dc_via_fleet"] = row
    emit({"phase": "whatif", "check": "dc_via_fleet", **row})
    assert all(row["via_fleet"]) and all(row["bitwise_equal_inline"]), row
    _expect(row["launches"], "whatif via fleet", cc=2 * DC_STEPS,
            seg=6 * DC_STEPS)

    SWEEP_EXEC_CACHE.clear()
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "whatif", "seconds": rec["seconds"]})
    return rec


# ---------------------------------------------------------------------------
# phase 11: the dc sweep through the fleet
# ---------------------------------------------------------------------------

FLEET_CONFIG = dict(n_workers=2, n_shards=4)


def phase_fleet(device, dc: dict) -> dict:
    """``run_fleet`` of the dc sweep on the card (2 worker threads, 4
    streamed shards, journaled): merged bitwise equal to phase 6's
    result, one capture, peak memory beside the dc phase's, the overhead
    against its wall; then a plan of the same sweep at phase 6's check
    depth preempted after 2 shards and resumed from its journal, bitwise
    equal to phase 6's card run of that depth."""
    import tempfile
    import torch
    from repro_torch.core import SWEEP_EXEC_CACHE
    from repro_torch.fleet import (FleetConfig, FleetRunner, PreemptedError,
                                   plan_sweep, run_fleet)
    t_phase = time.perf_counter()
    sweep = _dc_sweep()
    SWEEP_EXEC_CACHE.clear()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        reset_counts()
        t0 = time.perf_counter()
        out = run_fleet(sweep, n_steps=DC_STEPS, trace_every=100,
                        config=FleetConfig(**FLEET_CONFIG),
                        journal=os.path.join(tmp, "full"), device=device)
        wall = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        same, abs_d, _ = _result_diff(out.result, dc["result"])
        rec = {"phase": "fleet", "runs": len(sweep.points),
               "steps": DC_STEPS, "config": FLEET_CONFIG,
               "shards": len(out.plan.shards),
               "width": out.plan.buckets[0].width, "wall_s": wall,
               "dc_wall_s": dc["wall_s"], "overhead": wall / dc["wall_s"] - 1,
               "stats": out.stats.to_dict(), "launches": launches,
               "bitwise_equal_dc": same, "max_abs_diff": abs_d,
               "max_memory_allocated": peak,
               "peak_above_start": peak - base,
               "dc_max_memory_allocated": dc["max_memory_allocated"]}
        emit(rec)
        assert same, ("fleet differs from the dc sweep", abs_d)
        assert out.stats.compiles == 1 and out.stats.abandoned == 0, rec
        _expect(launches, "fleet dc", cc=len(out.plan.shards) * DC_STEPS)

        # preempted after 2 committed shards (one worker), then resumed:
        # the same sweep's plan at the dc phase's check depth (the shards'
        # capture serves it: depth is no part of a window's structure),
        # held to the dc phase's card run of that depth
        plan = plan_sweep(sweep, DC_CHECK_STEPS, 100, device=device,
                          n_shards=FLEET_CONFIG["n_shards"])
        journal = os.path.join(tmp, "preempt")
        t0 = time.perf_counter()
        try:
            FleetRunner(plan, FleetConfig(n_workers=1, preempt_after=2),
                        journal=journal).run()
            preempted = False
        except PreemptedError:
            preempted = True
        again = FleetRunner(plan, FleetConfig(n_workers=2),
                            journal=journal).run()
        rec["preempt_resume"] = {
            "steps": DC_CHECK_STEPS, "preempted": preempted,
            "resumed": again.stats.resumed,
            "executed": again.stats.executed,
            "compiles": again.stats.compiles,
            "seconds": time.perf_counter() - t0,
            "bitwise_equal_dc": _result_diff(again.result,
                                             dc["check_result"])[0]}
    emit({"phase": "fleet", "check": "preempt_resume",
          **rec["preempt_resume"]})
    pr = rec["preempt_resume"]
    assert pr["preempted"] and pr["resumed"] == 2 and pr["executed"] == 2, pr
    assert pr["bitwise_equal_dc"], pr
    SWEEP_EXEC_CACHE.clear()
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "fleet", "seconds": rec["seconds"]})
    return rec


# ---------------------------------------------------------------------------
# phase 12: the ERP pacer
# ---------------------------------------------------------------------------

#: examples/paced_collectives.py's gradient tree, fp32 layers of 1024 x
#: 1024 reduced in 8 chunks across 2 pods, cut from its 25 layers to 12
#: (9,000 steps a scheme, not 15,000) to keep the script under 600 s
#: with phase 17
PACER_LAYERS, PACER_CHUNKS, PACER_PODS = 12, 8, 2
PACER_SCHEMES = ("PFC_ONLY", "DCQCN", "DCQCN_REV")


def _pacer_chunks(device=None) -> list:
    """``chunk_bytes_of`` the example's tree: numpy arrays, or tensors on
    ``device``."""
    import numpy as np
    import torch
    from repro_torch.dist import chunk_bytes_of
    zeros = (lambda: np.zeros((1024, 1024), np.float32)) if device is None \
        else (lambda: torch.zeros((1024, 1024), device=device))
    return chunk_bytes_of({f"layer{i}": zeros() for i in range(PACER_LAYERS)},
                          PACER_CHUNKS)


def pacer_cpu(scheme: str) -> dict:
    """One scheme's schedule on the CPU (a child process, one thread)."""
    import torch
    from repro_torch.dist import erp_chunk_schedule
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = erp_chunk_schedule(_pacer_chunks(), n_pods=PACER_PODS,
                             scheme_name=scheme, device="cpu")
    return {**out, "seconds": time.perf_counter() - t0}


def phase_pacer(device, children: dict) -> dict:
    """``erp_chunk_schedule`` of the example's tree for each scheme on the
    card (every CC kernel once a step; DCQCN_REV's reaction is
    ``erp_step``), against the same schedule on the CPU (child processes
    started with the script) at the golden tolerance."""
    import numpy as np
    from repro_torch.dist import erp_chunk_schedule
    t_phase = time.perf_counter()
    chunks = _pacer_chunks(device)
    assert chunks == _pacer_chunks(), "tensor and numpy trees differ"
    rec = {"phase": "pacer", "chunks": chunks, "bytes": sum(chunks),
           "pods": PACER_PODS, "schemes": {}}
    for scheme in PACER_SCHEMES:
        reset_counts()
        t0 = time.perf_counter()
        card = erp_chunk_schedule(chunks, n_pods=PACER_PODS,
                                  scheme_name=scheme, device=device)
        wall = time.perf_counter() - t0
        launches = counts()
        cpu = _join(children.pop(scheme), f"the pacer's CPU {scheme}")
        close = all(np.allclose(card[k], cpu[k], rtol=2e-3, atol=0.0)
                    for k in ("completion_ms", "victim_gbps", "chunks"))
        steps = launches["gen_np_step"]
        rec["schemes"][scheme] = {
            "card": card, "cpu": cpu, "wall_s": wall, "steps": steps,
            "steps_per_s": steps / wall, "launches": launches,
            "within_golden_tolerance": close}
        assert steps > 0 and steps % 1000 == 0, launches
        _expect(launches, f"pacer {scheme}", cc=steps)
        assert close and np.isfinite(card["completion_ms"]), (card, cpu)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 13: the attention kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN = {
    # name: (source, TPU kernel it replaces); flash_attention is the
    # tensor-core route (bf16 at d 64/128/256: the serve cell,
    # recurrentgemma), flash_attention_cuda_core the route float32 takes
    # (serve_f32); decode_attention the split kernel (gemma2's g 2),
    # decode_attention_group the group kernel (bf16 at g 6-16:
    # recurrentgemma, mixtral, internvl2)
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:103"),
    "flash_attention_cuda_core": ("src/repro_torch/csrc/flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:103"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:71"),
    "decode_attention_group": ("src/repro_torch/csrc/decode_attention.cu",
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
#: kernels sum in another order, with their own exp / tanh and, in
#: decode, float32 softmax weights (the 2e-2 kernel bound), in each of
#: 46 layers.
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
    # whisper-base's decoder prompt (4 tokens, shorter than one 64-row
    # tile) and internvl2-26b's joint prefill (phase 17)
    (4, 4, 8, 8, 64, True, None, 0.0),
    (2, 2048, 48, 8, 128, True, None, 0.0),
    # recurrentgemma's heads at d 256 (64-key tiles on the tensor-core
    # route): under a window that skips tiles, ragged with a softcap,
    # shorter than one tile, non-causal
    (1, 520, 16, 1, 256, True, 100, 0.0),
    (2, 130, 16, 1, 256, True, None, 50.0),
    (2, 40, 16, 1, 256, True, None, 0.0),
    (1, 97, 8, 2, 256, False, None, 0.0),
]
#: tests/test_kernels.py:84-88 (b, s, h, kv, d, cap), then gemma2's
#: decode at the serve cell's cache lengths (global and local ring),
#: then whisper-base's and internvl2-26b's caches (phase 17)
DECODE_EDGE = [
    (2, 256, 8, 2, 64, 0.0),
    (1, 1000, 4, 1, 64, 50.0),
    (3, 128, 16, 8, 128, 0.0),
    (1, 64, 4, 4, 32, 0.0),
    (4, SERVE_MAX_LEN, 32, 16, 128, GEMMA_CAP),
    (4, 4096, 32, 16, 128, GEMMA_CAP),
    (4, 448, 8, 8, 64, 0.0),
    (2, 2176, 48, 8, 128, 0.0),
    # the group kernel's shapes (bf16): recurrentgemma's g 16 ring at d
    # 256, two kv heads, starcoder2's g 12, a cache shorter than a tile
    (2, 2048, 16, 1, 256, 0.0),
    (3, 323, 16, 2, 256, 50.0),
    (2, 700, 24, 2, 128, 0.0),
    (2, 40, 16, 1, 256, 0.0),
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
    DA = _kmod("decode_attention")
    FA = _kmod("flash_attention")
    errs, moved = {"flash": {}, "decode": {}}, {}
    for b, t, h, kv, d, window, cap in FLASH_CAP:
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(g, (b, t, h, d), dt, device, CAP_QK)
            k = _randn(g, (b, t, kv, d), dt, device, CAP_QK)
            v = _randn(g, (b, t, kv, d), dt, device, 1.0)
            kw = dict(window=window, scale=GEMMA_SCALE if h == 32 else None)
            f32 = [x.float() for x in (q, k, v)]
            want = FA.flash_attention_plain(*f32, softcap=cap, **kw)
            tag = (f"cap {b}x{t}x{h}/{kv}x{d} w{window} cap{cap} {dt} "
                   f"{FA._route(dt, d)}")
            errs["flash"][tag] = _held(
                _flash(q, k, v, softcap=cap, **kw),
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
            tag = (f"cap {b}x{s}x{h}/{kv}x{d} cap{cap} {dt} "
                   f"{DA.decode_plan(b, s, h, kv, d, dt).kernel}")
            errs["decode"][tag] = _held(
                _decode(q, k, v, valid, softcap=cap, **kw),
                want, str(dt)[6:], f"decode {tag}")
            moved[tag] = _beyond(DA.decode_attention_plain(*f32, valid, **kw),
                                 want, str(dt)[6:], f"decode {tag}")
    torch.cuda.empty_cache()
    return errs, moved


def _flash_edges(device, g) -> dict:
    import torch
    FA = _kmod("flash_attention")
    errs = {}
    for b, t, h, kv, d, causal, window, cap in FLASH_EDGE:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = [_randn(g, sh, dt, device) for sh in
                       ((b, t, h, d), (b, t, kv, d), (b, t, kv, d))]
            kw = dict(causal=causal, window=window, softcap=cap,
                      scale=GEMMA_SCALE if h == 32 else None)
            tag = (f"{b}x{t}x{h}/{kv}x{d} w{window} cap{cap} {dt} "
                   f"{FA._route(dt, d)}")
            errs[tag] = _held(_flash(q, k, v, **kw),
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
        got = _flash(q, k, v, window=window, softcap=GEMMA_CAP)
        want = FA.flash_attention_plain(q, k, v, window=window,
                                        softcap=GEMMA_CAP)
        seen = s + window - 1
        tag = f"all_skipped t{t} s{s} w{window} {dt} {FA._route(dt, d)}"
        errs[tag] = _held(got[:, :seen], want[:, :seen], str(dt)[6:], tag)
        assert not bool(got[:, seen:].any()), tag
    return errs


def _decode_edges(device, g) -> dict:
    import torch
    DA = _kmod("decode_attention")
    errs = {}
    for b, s, h, kv, d, cap in DECODE_EDGE:
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(g, (b, h, d), dt, device)
            k, v = [_randn(g, (b, s, kv, d), dt, device) for _ in range(2)]
            valid = torch.rand((b, s), generator=g, device=device) > 0.3
            kw = dict(softcap=cap, scale=GEMMA_SCALE if h == 32 else None)
            tag = (f"{b}x{s}x{h}/{kv}x{d} cap{cap} {dt} "
                   f"{DA.decode_plan(b, s, h, kv, d, dt).kernel}")
            errs[tag] = _held(_decode(q, k, v, valid, **kw),
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


#: the decode kernels' tiling edges: head dims and GQA group sizes (bf16
#: at g 8 and 16, d 64-256: the group kernel's 64-key tiles and splits)
DECODE_TILE_DIMS = (8, 32, 64, 128, 256)
DECODE_TILE_GROUPS = (1, 2, 4, 8, 16)


def _decode_tiling(device, g) -> dict:
    """decode_attention where its tiling has edges, in both dtypes
    against the plain version: at each d in DECODE_TILE_DIMS and g in
    DECODE_TILE_GROUPS (2 kv heads, batch 2) a cache of 5 tiles + 3
    slots (no multiple of the tile), the second tile wholly invalid (on
    the group kernel a whole split) and batch row 1 with no valid slot at
    all (the kernel's 0 there); each call on the kernel its plan names."""
    import torch
    DA = _kmod("decode_attention")
    errs = {}
    for d in DECODE_TILE_DIMS:
        for grp in DECODE_TILE_GROUPS:
            for dt in (torch.float32, torch.bfloat16):
                b, kv = 2, 2
                h = kv * grp
                tile = DA.decode_plan(b, 1, h, kv, d, dt).tile
                s = 5 * tile + 3
                q = _randn(g, (b, h, d), dt, device)
                k, v = [_randn(g, (b, s, kv, d), dt, device)
                        for _ in range(2)]
                valid = torch.rand((b, s), generator=g, device=device) > 0.3
                valid[:, tile:2 * tile] = False
                valid[1] = False
                plan = DA.decode_plan(b, s, h, kv, d, dt)
                tag = (f"tiling d{d} g{grp} s{s} tile{tile} "
                       f"split{plan.keys_per_split} {dt} {plan.kernel}")
                got = _decode(q, k, v, valid, softcap=GEMMA_CAP)
                want = DA.decode_attention_plain(q, k, v, valid,
                                                 softcap=GEMMA_CAP)
                errs[tag] = _held(got[:1], want[:1], str(dt)[6:], tag)
                assert not bool(got[1].any()), tag
    return errs


def _graph_or_events(fn, n: int = 50) -> tuple[float, str]:
    """(device ms a call, how it was timed): CUDA-graph replay where
    ``fn`` can be captured, else CUDA events over eager calls."""
    import torch
    try:
        return _time_ms(fn, n)[0], "cuda graph replay"
    except Exception as e:                     # not capturable
        torch.cuda.synchronize()
        return _event_ms(fn, n), (f"cuda events over eager calls "
                                  f"({type(e).__name__})")


def _flex_call(qT, kT, vT, *, window, valid, scale=GEMMA_SCALE,
               cap=GEMMA_CAP):
    """One compiled ``flex_attention`` call computing the kernels'
    function at ``scale`` and softcap ``cap`` (gemma2's by default; 0 =
    none), on [b, heads, len, d] tensors: causal (and the window) for a
    prefill, the valid slots for a decode query.  Timed here only; the
    port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    b, _, t, _ = qT.shape
    s = kT.shape[2]

    def softcap(score, bb, hh, qi, ki):
        return torch.tanh(score / cap) * cap

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
    mod = softcap if cap else None
    return lambda: fn(qT, kT, vT, score_mod=mod, block_mask=bm,
                      scale=scale, enable_gqa=True)


#: the CUDA-core route's timed shapes: (name, (b, t, h, kv, d), dtype,
#: window, softcap, scale).  serve_f32's prefill (2 slots x 4200
#: positions, gemma2's heads, float32, softcap 50), its global and its
#: local layer; then recurrentgemma-9b's local attention in bfloat16
#: (16/1 heads, d 256, window 2048, no softcap): the tensor-core route's
#: since it takes d 256, so the CUDA-core kernel is launched there by
#: name, timed beside the tensor-core route on the same inputs
CC_SHAPES = [
    ("global", (2, SERVE_PROMPT[1], *GEMMA_HEADS), "float32", None,
     GEMMA_CAP, GEMMA_SCALE),
    ("local", (2, SERVE_PROMPT[1], *GEMMA_HEADS), "float32", 4096,
     GEMMA_CAP, GEMMA_SCALE),
    ("recurrentgemma_local_bf16", (2, SERVE_PROMPT[1], 16, 1, 256),
     "bfloat16", 2048, 0.0, None),
]


def _sdpa_call(qT, kT, vT, *, window, scale):
    """``scaled_dot_product_attention`` computing the kernels' function at
    softcap 0 (causal, the window as a boolean mask, GQA) on [b, heads,
    len, d] tensors.  Timed here only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            qT, kT, vT, is_causal=True, scale=scale, enable_gqa=True)
    pos = torch.arange(qT.shape[2], device=qT.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    return lambda: F.scaled_dot_product_attention(
        qT, kT, vT, attn_mask=mask, scale=scale, enable_gqa=True)


def _flash_cuda_core(device, g, flash_errs: dict) -> dict:
    """The CUDA-core route at CC_SHAPES: each shape held against the
    plain version run in float32 on the same values (the bf16 plain
    version rounds its logits), with the output's scale (largest and
    rms |plain|) and the rms error beside the largest error; kernel, plain and library time against the bound at the
    card's peak for the input dtype (the bf16 shape runs float32 FMAs
    here, but the card's bf16 rate is what the same work could take).
    The library: flex_attention where the softcap bites (gemma2's
    shapes), and scaled_dot_product_attention at softcap 0 with the
    kernel timed at softcap 0 beside it.  Where ``_route`` sends the
    shape to the tensor cores (bf16 at d 256) the CUDA-core kernel is
    launched by name, and the routed kernel is held (``_held``,
    ``_held_rows``) and timed beside it on the same inputs.  The errors
    of every CUDA-core case checked in this phase, by dtype."""
    import torch
    FA = _kmod("flash_attention")
    times = {}
    for name, (b, t, h, kv, d), dt, window, cap, scale in CC_SHAPES:
        dtype = getattr(torch, dt)
        q = _randn(g, (b, t, h, d), dtype, device)
        k, v = [_randn(g, (b, t, kv, d), dtype, device) for _ in range(2)]
        kw = dict(window=window, softcap=cap, scale=scale)

        def cc(**over):                       # the CUDA-core kernel
            return FA._launch("cuda_core", q, k, v, causal=True,
                              **{**kw, **over})
        first = cc()
        same = bool(torch.equal(first, cc()))
        assert same, ("flash_attention cuda_core rerun", name)
        want = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                        **kw)
        plain_err = _held(first, want, dt, f"plain {dt} {name}")
        # the output's scale beside the error: the largest |plain| is set
        # by the first rows (row 0 is v[0]); the rms by the long rows
        scale_rec = {"plain_max_abs": float(want.abs().max()),
                     "plain_rms": float(want.square().mean().sqrt()),
                     "plain_err_rms": float(
                         (first.float() - want).square().mean().sqrt())}
        routed = FA._route(dtype, d)
        tc = None
        if routed != "cuda_core":             # the routed kernel beside it
            got = _flash(q, k, v, **kw)
            tc = {"route": routed,
                  "max_abs_err": _held(got, want, dt, f"{routed} {name}"),
                  "max_row_rel_err": _held_rows(got, want,
                                                f"{routed} {name}"),
                  "rerun_bitwise_equal": bool(torch.equal(
                      got, FA.flash_attention(q, k, v, **kw)))}
            assert tc["rerun_bitwise_equal"], (routed, name)
            del got
        del first, want
        ms = _event_ms(cc, 3)
        plain_ms = _event_ms(
            lambda: FA.flash_attention_plain(q, k, v, **kw), 1)
        fl = _flash_flops(q.shape, t, causal=True, window=window)
        nbytes = q.element_size() * (q.numel() * 2 + k.numel() + v.numel())
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        peak = BF16_FLOPS if dt == "bfloat16" else FP32_FLOPS
        o_ms = fl / peak * 1e3
        rec = {"shape": [b, t, h, kv, d], "dtype": dt, "window": window,
               "softcap": cap, "route": "cuda_core",
               "plain_max_abs_err": plain_err,
               **scale_rec, "peak_flops": peak,
               "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(b_ms, o_ms),
               "bound_by": "bytes" if b_ms >= o_ms else "operations",
               "bound_share": max(b_ms, o_ms) / ms, "flops": fl,
               "tflops_per_s": fl / ms / 1e9, "rerun_bitwise_equal": same,
               "smem_bytes": FA._lib().fa_smem_bytes(d)}
        if tc is not None:
            tc["ms"] = _event_ms(lambda: FA.flash_attention(q, k, v, **kw),
                                 10)
            tc["bound_share"] = max(b_ms, o_ms) / tc["ms"]
            tc["tflops_per_s"] = fl / tc["ms"] / 1e9
            tc["speedup_over_cuda_core"] = ms / tc["ms"]
            rec["routed"] = tc
        qT, kT, vT = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if cap:
            lib = _flex_call(qT, kT, vT, window=window, valid=None)
            rec["flex_max_abs_err"] = _held(
                cc(), lib().transpose(1, 2), dt, f"flex {dt} {name}")
            rec["flex_ms"] = _event_ms(lib, 5)
            rec["kernel_faster_than_flex"] = ms <= rec["flex_ms"]
        lib = _sdpa_call(qT, kT, vT, window=window, scale=scale)
        kw0 = dict(kw, softcap=0.0)
        # SDPA's float32 backends may multiply in TF32: it is held to the
        # bf16 bound, as the same function, not as a second oracle
        rec["sdpa_softcap0_max_abs_err"] = _held(
            cc(softcap=0.0), lib().transpose(1, 2), "bfloat16",
            f"sdpa {dt} {name}")
        rec["sdpa_softcap0_ms"] = _event_ms(lib, 3)
        rec["kernel_softcap0_ms"] = _event_ms(lambda: cc(softcap=0.0), 3)
        if tc is not None:
            tc["softcap0_ms"] = _event_ms(
                lambda: FA.flash_attention(q, k, v, **kw0), 10)
            tc["faster_than_sdpa_softcap0"] = \
                tc["softcap0_ms"] <= rec["sdpa_softcap0_ms"]
        times[name] = rec
        del q, k, v, qT, kT, vT, lib
        torch.cuda.empty_cache()
    by_dtype = {}
    for tag, e in flash_errs.items():
        if "cuda_core" in tag:
            key = "bfloat16" if "bfloat16" in tag else "float32"
            by_dtype[key] = max(by_dtype.get(key, 0.0), e)
    for rec in times.values():
        by_dtype[rec["dtype"]] = max(by_dtype.get(rec["dtype"], 0.0),
                                     rec["plain_max_abs_err"])
    top = times["global"]
    return {"times": times, "dtype": "float32",
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["flex_ms"],
            "max_abs_err": by_dtype["float32"],
            "max_abs_err_by_dtype": by_dtype}


def phase_attention(device) -> dict:
    """Both kernels against their plain versions at every case; timed at
    the serve cell's shapes (batch 4, prompt 4200, cache 4352, bf16),
    with the bound, flex_attention at softcap 50 (the library call of
    the same function) and, at softcap 0, scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F
    DA = _kmod("decode_attention")
    FA = _kmod("flash_attention")
    g = torch.Generator(device=device).manual_seed(9)
    flash_errs = _flash_edges(device, g)
    decode_errs = _decode_edges(device, g)
    decode_errs.update(_decode_tiling(device, g))
    cap_errs, moved = _cap_cases(device, g)
    flash_errs.update(cap_errs["flash"])
    decode_errs.update(cap_errs["decode"])
    h, kv, d = GEMMA_HEADS
    bf = torch.bfloat16
    rows, rec = {}, {"phase": "attention", "flash_max_abs_err": flash_errs,
                     "decode_max_abs_err": decode_errs,
                     "nocap_max_abs_diff": moved}

    # flash at a prefill of the serve cell: 4 slots x 4200 positions, on
    # the tensor-core route (bf16, d = 128).  Its bound is the larger of
    # bytes and tensor-core operations; beside it, the SFU term: one ex2
    # and one tanh per visible logit at SFU_PER_CLOCK a clock per SM
    b, t = SERVE_SLOTS, SERVE_PROMPT[1]
    q = _randn(g, (b, t, h, d), bf, device)
    k, v = [_randn(g, (b, t, kv, d), bf, device) for _ in range(2)]
    _flash(q, k, v, softcap=GEMMA_CAP, scale=GEMMA_SCALE)   # the route
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    times = {}
    for layer, window in (("global", None), ("local", 4096)):
        kw = dict(window=window, softcap=GEMMA_CAP, scale=GEMMA_SCALE)
        ms = _event_ms(lambda: FA.flash_attention(q, k, v, **kw), 10)
        plain_ms = _event_ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                             1)
        fl = _flash_flops(q.shape, t, causal=True, window=window)
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = fl / BF16_FLOPS * 1e3
        trans = 2 * fl / (4 * d)          # visible logits x (ex2 + tanh)
        sfu_ms = trans / (SFU_PER_CLOCK * sms * clock_mhz * 1e6) * 1e3
        times[layer] = {"us": ms * 1e3, "plain_us": plain_ms * 1e3,
                        "bound_us": max(b_ms, o_ms) * 1e3,
                        "bound_by": "bytes" if b_ms >= o_ms else "operations",
                        "bound_share": max(b_ms, o_ms) / ms,
                        "sfu_us": sfu_ms * 1e3, "transcendentals": trans,
                        "flops": fl, "tflops_per_s": fl / ms / 1e9}
        torch.cuda.empty_cache()
    # scaled_dot_product_attention computes the same function at softcap
    # 0 (boolean mask, GQA): time it beside the kernel at softcap 0
    qT, kT, vT = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = {}
    for layer, window in (("global", None), ("local", 4096)):
        lib = _sdpa_call(qT, kT, vT, window=window, scale=GEMMA_SCALE)
        kw = dict(window=window, scale=GEMMA_SCALE)
        err = _held(_flash(q, k, v, **kw),
                    lib().transpose(1, 2), "bfloat16", f"sdpa {layer}")
        sdpa[layer] = {
            "library_us": _event_ms(lib, 5) * 1e3,
            "kernel_softcap0_us": _event_ms(
                lambda: FA.flash_attention(q, k, v, **kw), 10) * 1e3,
            "max_abs_err_vs_kernel": err}
        # kernel / SDPA on the same function (softcap 0): < 1 is faster
        sdpa[layer]["sdpa_ratio"] = (sdpa[layer]["kernel_softcap0_us"]
                                     / sdpa[layer]["library_us"])
    flex = {}
    for layer, window in (("global", None), ("local", 4096)):
        lib = _flex_call(qT, kT, vT, window=window, valid=None)
        err = _held(_flash(q, k, v, window=window, softcap=GEMMA_CAP,
                           scale=GEMMA_SCALE),
                    lib().transpose(1, 2), "bfloat16", f"flex {layer}")
        flex[layer] = {"library_us": _event_ms(lib, 5) * 1e3,
                       "max_abs_err_vs_kernel": err}
        flex[layer]["kernel_faster"] = \
            times[layer]["us"] <= flex[layer]["library_us"]
    rec["flash"] = {"shape": [b, t, h, kv, d], "dtype": "bfloat16",
                    "route": "tensor_core", "softcap": GEMMA_CAP,
                    "sm_clock_mhz": clock_mhz, "sms": sms, "times": times,
                    "flex_softcap50": flex, "sdpa_softcap0": sdpa}
    del q, k, v, qT, kT, vT, lib
    torch.cuda.empty_cache()
    tc_errs = [e for tag, e in flash_errs.items() if "tensor_core" in tag]
    rows["flash_attention"] = {
        "ms": times["global"]["us"] / 1e3,
        "plain_ms": times["global"]["plain_us"] / 1e3,
        "bound_ms": times["global"]["bound_us"] / 1e3,
        "bound_by": times["global"]["bound_by"],
        "library_ms": flex["global"]["library_us"] / 1e3,
        "max_abs_err": max(tc_errs)}
    rec["flash_cuda_core"] = rows["flash_attention_cuda_core"] = \
        _flash_cuda_core(device, g, flash_errs)
    worst = {}
    for tag, e in flash_errs.items():
        route = "tensor_core" if "tensor_core" in tag else "cuda_core"
        key = f"{route} {'bfloat16' if 'bfloat16' in tag else 'float32'}"
        worst[key] = max(worst.get(key, 0.0), e)
    rec["flash_max_abs_err_by_route_dtype"] = worst
    # decode at a step of the serve cell: 4 slots, global cache of 4352
    # slots (4215 valid) and a full local ring of 4096
    times, sdpa, flex = {}, {}, {}
    for layer, s, n_valid in (("global", SERVE_MAX_LEN, 4215),
                              ("local", 4096, 4096)):
        q = _randn(g, (b, h, d), bf, device, FAM_QK_SD)
        k = _randn(g, (b, s, kv, d), bf, device, FAM_QK_SD)
        v = _randn(g, (b, s, kv, d), bf, device)
        valid = (torch.arange(s, device=device) < n_valid).expand(b, s)
        valid = valid.contiguous()
        kw = dict(softcap=GEMMA_CAP, scale=GEMMA_SCALE)
        kern = lambda: DA.decode_attention(q, k, v, valid, **kw)  # noqa
        rerun_same = bool(torch.equal(kern(), kern()))
        # device time from CUDA-graph replay: at ~70 us the wrapper's
        # host cost is comparable to the launch, so eager events would
        # time the host (the eager time is kept beside it)
        ms, eager_ms = _time_ms(kern, 50)
        plain_ms = _event_ms(
            lambda: DA.decode_attention_plain(q, k, v, valid, **kw), 5)
        # K/V rows of the valid slots only (the kernel loads no other),
        # q in and out in bf16, the mask
        nbytes = 2 * (2 * b * n_valid * kv * d + 2 * q.numel()) \
            + valid.numel()
        fl = 4.0 * b * h * n_valid * d
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = fl / BF16_FLOPS * 1e3
        plan = DA.decode_plan(b, s, h, kv, d, bf)
        times[layer] = {"us": ms * 1e3, "timed_by": "cuda graph replay",
                        "eager_us": eager_ms * 1e3,
                        "plain_us": plain_ms * 1e3,
                        "bound_us": max(b_ms, o_ms) * 1e3,
                        "bound_by": "bytes" if b_ms >= o_ms else "operations",
                        "bound_share": max(b_ms, o_ms) / ms,
                        "bytes": nbytes, "tb_per_s": nbytes / ms / 1e9,
                        "rerun_bitwise_equal": rerun_same,
                        "plan": plan._asdict()}
        assert rerun_same, ("decode_attention rerun", layer)
        # the group kernel's plan beside the split plan gemma2 takes
        gp = DA.decode_plan(b, s, h, kv, d, bf, kernel="group")
        run = lambda: DA._launch(gp, q, k, v, valid, **kw)  # noqa: E731
        times[layer]["group_plan"] = {
            "plan": gp._asdict(), "us": _time_ms(run, 50)[0] * 1e3,
            "max_abs_err": _held(run(), kern(), "bfloat16",
                                 f"decode group {layer}")}
        qT, kT, vT = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        kT, vT = kT.contiguous(), vT.contiguous()
        mask = valid[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qT, kT, vT, attn_mask=mask, scale=GEMMA_SCALE, enable_gqa=True)
        err = _held(DA.decode_attention(q, k, v, valid, scale=GEMMA_SCALE),
                    lib()[:, :, 0], "bfloat16", f"sdpa decode {layer}")
        lib_ms, how = _graph_or_events(lib)
        sdpa[layer] = {
            "library_us": lib_ms * 1e3, "timed_by": how,
            "kernel_softcap0_us": _time_ms(lambda: DA.decode_attention(
                q, k, v, valid, scale=GEMMA_SCALE), 50)[0] * 1e3,
            "max_abs_err_vs_kernel": err}
        lib = _flex_call(qT, kT, vT, window=None, valid=valid)
        err = _held(DA.decode_attention(q, k, v, valid, **kw),
                    lib()[:, :, 0], "bfloat16", f"flex decode {layer}")
        lib_ms, how = _graph_or_events(lib)
        flex[layer] = {"library_us": lib_ms * 1e3, "timed_by": how,
                       "max_abs_err_vs_kernel": err,
                       "kernel_faster": ms < lib_ms}
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
        "max_abs_err": max(e for tag, e in decode_errs.items()
                           if not tag.endswith("group"))}
    # the group kernel's row: its errors here; its times at
    # recurrentgemma's served shape come from phase 15 (_group_row)
    rows["decode_attention_group"] = {
        "max_abs_err": max(e for tag, e in decode_errs.items()
                           if tag.endswith("group"))}
    emit(rec)
    torch.cuda.empty_cache()
    for name, row in rows.items():
        row.update({"name": name, "route": "cuda", "source": ATTN[name][0],
                    "replaces": ATTN[name][1], "launches": None})
    return rows


# ---------------------------------------------------------------------------
# phases 11-13: serving gemma2-27b
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


def _attn_layers(cfg) -> int:
    """The layers of ``cfg`` that run attention (one flash launch a
    prefill call, one decode launch a decode step, each)."""
    from repro_torch.models import transformer as T
    return sum(k in T.ATTN_KINDS for k in T.layer_kinds(cfg))


def _logit_diff(a, b) -> dict:
    import torch
    diff = float((a - b).abs().max())
    scale = float(b.abs().max())
    return {"max_abs_diff": diff, "max_abs_logit": scale,
            "rel": diff / scale,
            "mean_abs_diff": float((a - b).abs().mean()),
            "argmax_equal": bool(torch.equal(a.argmax(-1), b.argmax(-1))),
            "finite": bool(torch.isfinite(a).all())}


def _model_fns(cfg, params, inputs, max_len: int):
    """A model's entry points on ``inputs`` (``tokens``, and ``frames`` or
    ``patches``): ``prefill(caches=None)`` -> (logits, caches, extra) and
    ``step(token, caches, pos, extra)`` -> logits.  A decoder-only LM:
    ``transformer.prefill`` / ``decode_step``; the encoder-decoder:
    ``encdec.prefill`` / ``decode_step`` (extra = enc_out); the VLM:
    ``vlm.prefill``, then ``transformer.decode_step`` from p + t."""
    from repro_torch.models import encdec, transformer, vlm
    if cfg.encdec is not None:
        def prefill(caches=None):
            return encdec.prefill(params, cfg, inputs["frames"],
                                  inputs["tokens"], max_len, caches=caches)

        def step(token, caches, pos, enc_out):
            return encdec.decode_step(params, cfg, token, enc_out, caches,
                                      pos)[0]
        return prefill, step

    def prefill(caches=None):
        if cfg.vlm is not None:
            logits, caches = vlm.prefill(params, cfg, inputs["patches"],
                                         inputs["tokens"], max_len,
                                         caches=caches)
        else:
            logits, caches = transformer.prefill(
                params, cfg, inputs["tokens"], max_len, caches=caches)
        return logits, caches, None

    def step(token, caches, pos, _):
        return transformer.decode_step(params, cfg, token, caches, pos)[0]
    return prefill, step


def _prompt_len(cfg, inputs) -> int:
    """Positions a prefill of ``inputs`` fills (patches + tokens)."""
    t = inputs["tokens"].shape[1]
    return t + (cfg.vlm.n_patches if cfg.vlm is not None else 0)


def _prompt_inputs(prompt, device) -> dict:
    """A decoder-only model's inputs: one prompt at batch 1."""
    import torch
    return {"tokens": torch.tensor([prompt], dtype=torch.int32,
                                   device=device)}


def _kernel_vs_plain(params, cfg, inputs, route: str,
                     max_len: int = SERVE_MAX_LEN) -> dict:
    """Prefill and first decode logits at batch 1 (the inputs' first row)
    through the kernels and through the plain path (the same params with
    ``use_pallas`` off): their differences (``prefill``, ``decode``),
    with each path's exact launches; every flash launch takes
    ``route``."""
    import dataclasses
    import torch
    one = {k: v[:1] for k, v in inputs.items()}
    n_layers = _attn_layers(cfg)
    nxt, out = [], []
    for c, where in ((cfg, "batch 1"),
                     (dataclasses.replace(cfg, use_pallas=False),
                      "batch 1 plain")):
        prefill, step = _model_fns(c, params, one, max_len)
        reset_counts()
        with torch.no_grad():
            lg, caches, extra = prefill()
            if not nxt:
                nxt.append(lg[:, -1].argmax(-1, keepdim=True).to(
                    torch.int32))
            pos = torch.tensor(_prompt_len(cfg, one), dtype=torch.int32,
                               device=lg.device)
            dg = step(nxt[0], caches, pos, extra)
        del caches, extra
        n = n_layers if c.use_pallas else 0
        _expect(counts(), f"{cfg.name} {where}", flash=n, decode=n)
        _expect_routes(routes(), f"{cfg.name} {where}", **{route: n})
        out.append((lg.float(), dg.float()))
    (lk, dk), (lr, dr) = out
    return {"prefill": _logit_diff(lk, lr), "decode": _logit_diff(dk, dr)}


def _device_us(prof) -> tuple[dict, int]:
    """Device microseconds by kernel name in a torch.profiler trace (sum
    of kernel and copy durations on the one stream), and the number of
    device events."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per = {}
    for e in dev:
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    return per, len(dev)


def _profile_decode(cfg, params, prompts, device, decode_us: float,
                    n: int = 5) -> dict:
    """``n`` of the engine's decode steps on the serve cell's 4 slots
    (prompts cut to the shortest length), each followed by the engine's
    host-side read of the logits: wall ms a step captured (the engine's
    graph replay) and eager (the same step, ``eng._decode``, issued op by
    op), and captured under torch.profiler; device busy ms a step (sum
    of kernel and copy durations on the one stream, or CUDA events
    around each replay where the profiler sees no kernel inside the
    graph), the idle share against both walls, and the heaviest kernels.
    Should the trace hold no ``decode_attention`` kernel, busy time adds
    its launches at ``decode_us`` each, and says so."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeConfig, ServingEngine
    eng = ServingEngine(cfg, params, ServeConfig(
        batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, eos_token=-1),
        device=device)
    t = SERVE_PROMPT[0]
    grid = np.asarray([p[:t] for p in prompts[:SERVE_SLOTS]], np.int32)
    cur = eng._joint_prefill(grid)[:, -1].float().cpu().numpy().argmax(-1)

    def eager(c):
        eng._token.copy_(torch.from_numpy(c[:, None].astype(np.int32)))
        with torch.no_grad():
            return eng._decode()

    def steps(k, fn=eng._step, events=None):
        nonlocal cur
        for _ in range(k):
            if events is not None:
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                events.append((a, b))
                a.record()
            logits = fn(cur.astype(np.int32))
            if events is not None:
                b.record()
            cur = logits[:, 0].float().cpu().numpy().argmax(-1)

    steps(2)                      # the first step warms up and captures
    t0 = time.perf_counter()
    steps(n)
    wall = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    steps(n, eager)
    eager_wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(n)
        pwall = (time.perf_counter() - t0) / n
    ev = []
    steps(n, events=ev)
    torch.cuda.synchronize()
    graph_ms = sum(a.elapsed_time(b) for a, b in ev) / n
    captures = eng.captures
    del steps, eager, eng
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"profiled_steps": n, "wall_ms_per_step": wall * 1e3,
           "eager_wall_ms_per_step": eager_wall * 1e3,
           "profiled_wall_ms_per_step": pwall * 1e3,
           "graph_ms_per_step_by_events": graph_ms, "captures": captures}
    per, n_ops = _device_us(prof)
    if not per:
        busy = graph_ms / 1e3
        rec.update({"device_timed_by": "cuda events around each replay "
                    "(the profiler saw no device events)",
                    "device_busy_ms_per_step": graph_ms,
                    "device_idle_share": 1.0 - busy / wall})
        return rec
    busy = sum(per.values()) / n / 1e6
    seen = sum(us for name, us in per.items() if "decode_" in name) / n
    rec["decode_attention_us_per_step_in_trace"] = seen
    if not seen:
        busy += cfg.n_layers * decode_us / 1e6
        rec["busy_adds_decode_attention_from_phase_attention_us"] = \
            cfg.n_layers * decode_us
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    rec.update({
        "device_timed_by": "torch.profiler",
        "device_busy_ms_per_step": busy * 1e3,
        "device_idle_share": 1.0 - busy / wall,
        "device_idle_share_profiled": 1.0 - busy / pwall,
        "device_ops_per_step": n_ops / n,
        "top_device_us_per_step": [[k[:80], v / n] for k, v in top]})
    return rec


def _profile_prefill(cfg, params, prompts, device) -> dict:
    """One prefill call of the serve cell (its 4 slots, prompts cut to
    the shortest length) under torch.profiler, after an unprofiled one:
    wall ms, device busy ms (sum of kernel and copy durations on the one
    stream), the idle share, flash_attention's share of busy time and
    the heaviest kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeConfig, ServingEngine
    eng = ServingEngine(cfg, params, ServeConfig(
        batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, eos_token=-1),
        device=device)
    t = SERVE_PROMPT[0]
    grid = np.asarray([p[:t] for p in prompts[:SERVE_SLOTS]], np.int32)

    def call():                  # drops the logits and caches it made
        eng._prefill(grid)
        torch.cuda.synchronize()

    call()
    t0 = time.perf_counter()
    call()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        pwall = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache()
    rec = {"grid": list(grid.shape), "wall_ms": wall * 1e3,
           "profiled_wall_ms": pwall * 1e3}
    per, n_ops = _device_us(prof)
    if not per:
        rec["device"] = "not measured (the profiler saw no device events)"
        return rec
    busy = sum(per.values()) / 1e6
    flash = sum(us for name, us in per.items() if "flash_tc" in name) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    rec.update({"device_busy_ms": busy * 1e3,
                "device_idle_share": 1.0 - busy / wall,
                "device_idle_share_profiled": 1.0 - busy / pwall,
                "flash_tc_ms_in_trace": flash * 1e3,
                "device_ops": n_ops,
                "top_device_us": [[k[:80], v] for k, v in top]})
    return rec


def _eager_serve(cfg, params, prompts, device, slots: int = SERVE_SLOTS,
                 max_len: int = SERVE_MAX_LEN,
                 new: int = SERVE_NEW) -> tuple[list, list]:
    """A serve cell's greedy tokens without the engine: each wave of
    ``slots`` prompts left-padded into one ``transformer.prefill``, then
    ``new`` - 1 eager ``transformer.decode_step`` calls (what the
    engine serves with EOS off).  Returns the tokens and each decode
    step's seconds (token upload to the step's end on the card, as
    ``_timed`` times the engine's)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    outs, secs = [], []
    with torch.no_grad():
        for w in range(0, len(prompts), slots):
            wave = prompts[w:w + slots]
            plen = max(len(p) for p in wave)
            grid = np.zeros((slots, plen), np.int32)
            for i, p in enumerate(wave):
                grid[i, plen - len(p):] = p
            logits, caches = T.prefill(params, cfg, torch.from_numpy(grid)
                                       .to(device), max_len)
            pos = torch.tensor(plen, dtype=torch.int32, device=device)
            cur = logits[:, -1].cpu().numpy().argmax(-1).astype(np.int32)
            toks = [cur]
            for _ in range(new - 1):
                t0 = time.perf_counter()      # as the engine's _step is
                tok = torch.from_numpy(cur[:, None].copy()).to(device)
                logits, caches = T.decode_step(params, cfg, tok, caches,
                                               pos)
                pos = pos + 1
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                cur = logits[:, 0].cpu().numpy().argmax(-1).astype(np.int32)
                toks.append(cur)
            del logits, caches
            outs += [[int(t[i]) for t in toks] for i in range(len(wave))]
    torch.cuda.empty_cache()
    return outs, secs


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
    launches, by_route, by_plan = counts(), routes(), plans()
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
           # the first step warms up and captures; the rest replay
           "first_decode_step_ms": calls["decode"][0][0] * 1e3,
           "replayed_decode_step_ms": (decode_s - calls["decode"][0][0])
           / max(n_decode - 1, 1) * 1e3,
           "generated_tokens": sum(len(o) for o in outs),
           "max_memory_allocated": peak, "launches": launches,
           "routes": by_route, "plans": by_plan}
    rec["captures"] = eng.captures
    assert st == {"prefills": 2, "refills": 0, "decode_steps": 30}, st
    assert all(len(o) == SERVE_NEW for o in outs), [len(o) for o in outs]
    assert eng.captures == 1, eng.captures
    _expect(launches, "serve", flash=n_layers * n_prefill,
            decode=n_layers * n_decode)
    _expect_routes(by_route, "serve", tensor_core=n_layers * n_prefill)
    _expect_plans(by_plan, "serve", split=n_layers * n_decode)   # g 2
    del eng, calls
    gc.collect()
    torch.cuda.empty_cache()
    # the same tokens through the eager decode_step loop
    t0 = time.perf_counter()
    eager_outs, secs = _eager_serve(cfg, params, prompts, device)
    rec["eager"] = {"seconds": time.perf_counter() - t0,
                    "decode_step_ms": sum(secs) / len(secs) * 1e3,
                    "decode_tokens_per_s": SERVE_SLOTS * len(secs)
                    / sum(secs),
                    "tokens_equal_captured": eager_outs == outs}
    rec["decode_speedup_captured_vs_eager"] = \
        rec["eager"]["decode_step_ms"] / rec["decode_step_ms"]
    assert eager_outs == outs, "captured serve tokens differ from eager"

    rec["prefill_profile"] = _profile_prefill(cfg, params, prompts, device)
    rec["decode_profile"] = _profile_decode(cfg, params, prompts, device,
                                            decode_us)
    # the kernel path against the plain path (use_pallas off) at batch 1:
    # the prefill logits and the first decode step's
    cmp = _kernel_vs_plain(params, cfg, _prompt_inputs(prompts[0], device),
                           "tensor_core")
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
    outs, launches, by_route, timing, captures = {}, {}, {}, {}, {}
    for path, c in (("kernels", cfg),
                    ("plain", dataclasses.replace(cfg, use_pallas=False))):
        eng = ServingEngine(c, params, sv, device=device)
        calls = _timed(eng)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        outs[path] = eng.generate(prompts, max_new_tokens=8)
        launches[path], by_route[path] = counts(), routes()
        captures[path] = eng.captures
        n_prefill, n_decode = len(calls["prefill"]), len(calls["decode"])
        # each prefill call: 2 slots x ~4200 positions, 2 layers
        timing[path] = {"ttft_s": calls["prefill"][0][2] - t0,
                        "prefill_s": [c_[0] for c_ in calls["prefill"]]}
        del eng, calls
        gc.collect()
        torch.cuda.empty_cache()
    cmp = _kernel_vs_plain(params, cfg, _prompt_inputs(prompts[0], device),
                           "cuda_core")
    rec = {"phase": "serve_f32", "layers": cfg.n_layers, "requests": 4,
           "slots": 2, "new_tokens": 8, "tokens_equal":
           outs["kernels"] == outs["plain"], "tokens": outs["kernels"],
           "launches": launches, "routes": by_route, "timing": timing,
           "captures": captures, "kernel_vs_plain_batch1": cmp,
           "logit_rtol": SERVE_F32_LOGIT_RTOL}
    emit(rec)
    for tag, c in cmp.items():
        assert c["finite"] and c["rel"] <= SERVE_F32_LOGIT_RTOL, (tag, c)
    _expect(launches["kernels"], "serve_f32", flash=2 * n_prefill,
            decode=2 * n_decode)
    _expect_routes(by_route["kernels"], "serve_f32", cuda_core=2 * n_prefill)
    _expect(launches["plain"], "serve_f32 plain")
    _expect_routes(by_route["plain"], "serve_f32 plain")
    assert rec["tokens_equal"], (outs["kernels"], outs["plain"])
    assert captures == {"kernels": 1, "plain": 1}, captures
    del params
    torch.cuda.empty_cache()
    return rec


def phase_card_vs_cpu(device) -> dict:
    """The gemma2 smoke config serves the same prompts on the card and
    on the CPU (the same float32 weights, made on the CPU): equal tokens,
    with EOS live so slots are refilled; then the launcher's --smoke run
    on the card.  The same for the four families' smoke configs
    (``_card_vs_cpu_family``), and the launcher on the first."""
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
    launches, by_route = counts(), routes()
    reset_counts()
    launcher.main(["--arch", "gemma2-27b", "--smoke"])
    launcher_launches = counts()
    rec = {"phase": "card_vs_cpu", "config": "gemma2-27b smoke",
           "tokens_equal": card_out == cpu_out, "stats": eng.stats,
           "cpu_stats": cpu_eng.stats, "launches": launches,
           "routes": by_route, "launcher_launches": launcher_launches,
           "captures": eng.captures}
    emit(rec)
    assert rec["tokens_equal"], (card_out, cpu_out)
    assert eng.captures == 1, eng.captures
    assert eng.stats == cpu_eng.stats and eng.stats["refills"] >= 1, rec
    _expect(launches, "card_vs_cpu", flash=cfg.n_layers * len(
        calls["prefill"]), decode=cfg.n_layers * len(calls["decode"]))
    # the smoke config is float32 at head_dim 16: the CUDA-core route
    _expect_routes(by_route, "card_vs_cpu",
                   cuda_core=cfg.n_layers * len(calls["prefill"]))
    assert launcher_launches["flash_attention"] > 0 and \
        launcher_launches["decode_attention"] > 0, launcher_launches
    rec["families"] = {arch: _card_vs_cpu_family(device, arch)
                       for arch, _ in FAMILIES}
    reset_counts()
    launcher.main(["--arch", FAMILIES[0][0], "--smoke"])
    rec["families_launcher"] = {"arch": FAMILIES[0][0],
                                "launches": counts()}
    emit({"phase": "card_vs_cpu_families", **rec["families"],
          "launcher": rec["families_launcher"]})
    assert rec["families_launcher"]["launches"]["decode_attention"] > 0
    rec["encdec_vlm"] = {arch: _card_vs_cpu_encdec_vlm(device, arch)
                         for arch in ("whisper-base", "internvl2-26b")}
    emit({"phase": "card_vs_cpu_encdec_vlm", **rec["encdec_vlm"]})
    return rec


def _card_vs_cpu_encdec_vlm(device, arch: str) -> dict:
    """``arch``'s smoke config (float32) through its model's prefill and
    a greedy decode loop (3 rows, 12 text tokens, 10 new) on the CPU and
    on the card (the decode captured, the same weights and stub inputs
    made on the CPU): equal tokens, exact launches (CUDA-core route)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import encdec, vlm
    from repro_torch.models.layers import init_params
    cfg = dataclasses.replace(get_smoke_config(arch), use_pallas=True)
    mod = encdec if cfg.encdec is not None else vlm
    host = init_params(mod.param_defs(cfg), 0, device="cpu")
    inputs = _stub_inputs(cfg, 3, 12, torch.float32, "cpu", seed=2)
    new, max_len = 10, 64
    card, card_inputs = _to(host, device), _to(inputs, device)
    cpu_out, _ = _greedy(cfg, host, inputs, max_len, new)
    reset_counts()
    card_out, _ = _greedy(cfg, card, card_inputs, max_len, new,
                          captured=True)
    launches, by_route = counts(), routes()
    with torch.no_grad():
        want = _model_fns(cfg, host, inputs, max_len)[0]()[0]
        got = _model_fns(cfg, card, card_inputs, max_len)[0]()[0].cpu()
    n = cfg.n_layers
    rec = {"tokens_equal": card_out == cpu_out, "launches": launches,
           "routes": by_route, "new_tokens": new,
           "distinct_tokens": len({t for row in card_out for t in row}),
           "prefill_logits": _logit_diff(got, want),
           "logit_rtol": SERVE_F32_LOGIT_RTOL}
    assert rec["tokens_equal"], (arch, card_out, cpu_out)
    assert rec["prefill_logits"]["rel"] <= SERVE_F32_LOGIT_RTOL, (arch, rec)
    _expect(launches, arch, flash=n, decode=n * (new - 1))
    _expect_routes(by_route, arch, cuda_core=n)
    return rec


#: card_vs_cpu's SSM chunk: the first wave's width, 32, is 4 chunks, so
#: that joint prefill takes the chunked scan, a refill's width the whole
#: one
CVC_SSM_CHUNK = 8


def _card_vs_cpu_family(device, arch: str) -> dict:
    """``arch``'s smoke config (float32) serves 6 prompts on 3 slots on
    the card and on the CPU, EOS live: equal tokens and stats, refills,
    one capture, exact launches (CUDA-core route)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = dataclasses.replace(get_smoke_config(arch), use_pallas=True)
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm_chunk=CVC_SSM_CHUNK)
    host = init_params(T.param_defs(cfg), 0, device="cpu")
    card = _to(host, device)
    prompts = _prompts(cfg.vocab, 6, 18, 40, seed=2)
    prompts[0] = (prompts[0] * 2)[:32]          # the first wave: 32 wide
    prompts[1], prompts[2] = prompts[1][:32], prompts[2][:32]
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
    launches, by_route = counts(), routes()
    n_attn = _attn_layers(cfg)
    widths = [c[1] // 3 for c in calls["prefill"]]
    rec = {"tokens_equal": card_out == cpu_out, "stats": eng.stats,
           "cpu_stats": cpu_eng.stats, "launches": launches,
           "routes": by_route, "captures": eng.captures,
           "prefill_widths": widths, "moe_impl": cfg.moe_impl
           if cfg.moe is not None else None}
    assert rec["tokens_equal"], (arch, card_out, cpu_out)
    assert eng.captures == 1, (arch, eng.captures)
    assert eng.stats == cpu_eng.stats and eng.stats["refills"] >= 1, \
        (arch, rec)
    _expect(launches, arch, flash=n_attn * len(calls["prefill"]),
            decode=n_attn * len(calls["decode"]))
    _expect_routes(by_route, arch,
                   cuda_core=n_attn * len(calls["prefill"]))
    if cfg.ssm is not None:      # both scan branches ran
        assert widths[0] == 32 and any(w % CVC_SSM_CHUNK for w in widths), \
            (arch, widths)
    return rec


# ---------------------------------------------------------------------------
# phase 16: serving the RG-LRU, SSM and MoE families
# ---------------------------------------------------------------------------

#: the families' serve cells (the repo's configs, bf16, random weights
#: from seed 0): (arch, layers; None = the config's full depth).
#: mixtral-8x22b (281 GB) runs at full width cut to 2 layers, as
#: serve_f32 cuts gemma2
FAMILIES = [("recurrentgemma-9b", None), ("falcon-mamba-7b", None),
            ("deepseek-moe-16b", None), ("mixtral-8x22b", 2)]
#: 4 requests of 1950-2048 random tokens on 2 slots, each wave's longest
#: exactly 2048 (falcon-mamba's joint prefills: 4 chunks of its 512), 16
#: new tokens each, EOS off, a cache of 2176
FAM_REQUESTS, FAM_SLOTS, FAM_PROMPT = 4, 2, (1950, 2048)
FAM_NEW, FAM_MAX_LEN = 16, 2176
#: the attention shapes the families (and, since phase 17, whisper-base
#: and internvl2-26b) bring onto a served path, timed at their serve
#: cells' sizes.  flash: (arch, (b, t, h, kv, d), window); decode: (arch,
#: (b, s, h, kv, d), valid slots, flex beside SDPA): a full 2048-slot
#: ring (recurrentgemma, g 16, d 256), the 2176-slot cache with 2063
#: valid (deepseek g 1, mixtral and internvl2 g 6, d 128), whisper's
#: 448-slot cache at its cell's last step (67 valid, g 1, d 64).  No
#: softcap; the scale 1/sqrt(d) (the configs' default)
#: the MoE models' kernel-vs-plain gate (SERVE_LOGIT_RTOL) runs on their
#: first 2 layers, mixtral-8x22b's serve cut: a bfloat16 difference in a
#: router's input swaps a token's k-th expert, and with depth the swaps
#: compound (deepseek-moe-16b's 28 layers: 123% apart, PERF.md), so the
#: full depth is recorded, not gated
FAM_MOE_GATE_LAYERS = 2
FAM_FLASH = [("recurrentgemma-9b", (2, 2048, 16, 1, 256), 2048),
             ("deepseek-moe-16b", (2, 2048, 16, 16, 128), None),
             ("mixtral-8x22b", (2, 2048, 48, 8, 128), 4096),
             ("whisper-base", (4, 4, 8, 8, 64), None),
             ("internvl2-26b", (2, 2048, 48, 8, 128), None)]
FAM_DECODE = [("recurrentgemma-9b", (2, 2048, 16, 1, 256), 2048, True),
              ("deepseek-moe-16b", (2, 2176, 16, 16, 128), 2063, True),
              ("mixtral-8x22b", (2, 2176, 48, 8, 128), 2063, False),
              ("whisper-base", (4, 448, 8, 8, 64), 67, False),
              ("internvl2-26b", (2, 2176, 48, 8, 128), 2063, False)]


#: ``_family_attention``'s gate beside ``_held``'s: each output row (one
#: query position, one head) of a kernel within FAM_ROW_RTOL of the row's
#: own largest |value| in its plain version run in float32 on the same
#: values.  q and k are drawn at sd FAM_QK_SD (scores of sd 2.25 at the
#: 1/sqrt(d) scale), so the softmax is peaked, not a mean over the keys
FAM_ROW_RTOL = 2e-2
FAM_QK_SD = 1.5


def _row_rel(got, want) -> float:
    """max over rows of max |got - want| / max |want| along the last
    axis (inf where either is not finite)."""
    import torch
    d = (got.float() - want.float()).abs().amax(-1)
    rel = d / want.float().abs().amax(-1)
    return float(torch.nan_to_num(rel, nan=float("inf")).max())


def _held_rows(got, want, where: str) -> float:
    """``_row_rel(got, want)``; raises beyond FAM_ROW_RTOL, or unless the
    gate fails ``got`` halved and zeros (it can tell a wrong kernel at
    this shape)."""
    import torch
    err = _row_rel(got, want)
    if not err <= FAM_ROW_RTOL:
        raise AssertionError(f"{where}: kernel differs from its plain "
                             f"version beyond {FAM_ROW_RTOL} of a row's "
                             f"largest value: {err}")
    for tag, bad in (("halved", got.float() * 0.5),
                     ("zeroed", torch.zeros_like(got, dtype=torch.float32))):
        if _row_rel(bad, want) <= FAM_ROW_RTOL:
            raise AssertionError(f"{where}: the row gate passes a {tag} "
                                 f"output")
    return err


def _family_prompts(vocab: int) -> list:
    import numpy as np
    rng = np.random.RandomState(0)
    lens = rng.randint(FAM_PROMPT[0], FAM_PROMPT[1] + 1, FAM_REQUESTS)
    lens[::FAM_SLOTS] = FAM_PROMPT[1]
    return [[int(x) for x in rng.randint(2, vocab, n)] for n in lens]


def _family_attention(device) -> dict:
    """Flash and decode at FAM_FLASH / FAM_DECODE: each held against its
    plain version run in float32 on the same values (``_held``, 2e-2,
    bf16, and row by row, ``_held_rows``), and timed beside its bound
    (bytes once, operations at the bf16 peak), SDPA at the same function
    and, for decode where flagged, ``flex_attention``; decode by
    CUDA-graph replay.  Beside the routed kernels, on the same inputs:
    flash at d 256 on the CUDA-core kernel (its route before the
    tensor-core kernel took d 256), and decode on the other kernel's plan
    where both can run (the split plan beside the group kernel, and the
    reverse)."""
    import math
    import torch
    import torch.nn.functional as F
    FA, DA = _kmod("flash_attention"), _kmod("decode_attention")
    g = torch.Generator(device=device).manual_seed(11)
    bf = torch.bfloat16
    flash, decode = {}, {}
    for arch, (b, t, h, kv, d), window in FAM_FLASH:
        q = _randn(g, (b, t, h, d), bf, device, FAM_QK_SD)
        k = _randn(g, (b, t, kv, d), bf, device, FAM_QK_SD)
        v = _randn(g, (b, t, kv, d), bf, device)
        kw = dict(window=window, scale=1.0 / math.sqrt(d))
        got = _flash(q, k, v, **kw)
        want = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                        **kw)
        err = _held(got, want, "bfloat16", f"flash {arch}")
        row_err = _held_rows(got, want, f"flash {arch}")
        old = {}
        if d == 256:             # the CUDA-core kernel, by name
            def cc():
                return FA._launch("cuda_core", q, k, v, causal=True,
                                  softcap=0.0, **kw)
            old = {"cuda_core_max_abs_err": _held(
                cc(), want, "bfloat16", f"flash cuda_core {arch}"),
                   "cuda_core_ms": _event_ms(cc, 3)}
        del want
        qT, kT, vT = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = _sdpa_call(qT, kT, vT, window=window, scale=kw["scale"])
        lib_err = _held(got, lib().transpose(1, 2), "bfloat16",
                        f"sdpa {arch}")
        # 20 calls: 5 left a sub-200-us kernel's time within ~25%
        # between runs
        ms = _event_ms(lambda: FA.flash_attention(q, k, v, **kw), 20)
        fl = _flash_flops(q.shape, t, causal=True, window=window)
        b_ms = 2 * (2 * q.numel() + k.numel() + v.numel()) \
            / HBM_BYTES_PER_S * 1e3
        o_ms = fl / BF16_FLOPS * 1e3
        flash[arch] = {
            "shape": [b, t, h, kv, d], "window": window,
            "route": FA._route(bf, d), "ms": ms,
            "plain_ms": _event_ms(
                lambda: FA.flash_attention_plain(q, k, v, **kw), 1),
            "library_ms": _event_ms(lib, 5), "library": "sdpa",
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bound_share": max(b_ms, o_ms) / ms, "flops": fl,
            "tflops_per_s": fl / ms / 1e9, "max_abs_err": err,
            "max_row_rel_err": row_err, "sdpa_max_abs_err": lib_err, **old}
        if old:
            flash[arch]["speedup_over_cuda_core"] = old["cuda_core_ms"] / ms
        if d == 128:             # kernel / SDPA: < 1 is faster
            flash[arch]["sdpa_ratio"] = ms / flash[arch]["library_ms"]
        del q, k, v, qT, kT, vT, lib, got
        torch.cuda.empty_cache()
    for arch, (b, s, h, kv, d), n_valid, with_flex in FAM_DECODE:
        q = _randn(g, (b, h, d), bf, device)
        k, v = [_randn(g, (b, s, kv, d), bf, device) for _ in range(2)]
        valid = (torch.arange(s, device=device) < n_valid).expand(b, s)
        valid = valid.contiguous()
        scale = 1.0 / math.sqrt(d)
        kern = lambda: DA.decode_attention(q, k, v, valid,  # noqa: E731
                                           scale=scale)
        plan = DA.decode_plan(b, s, h, kv, d, bf)
        got = _decode(q, k, v, valid, scale=scale)
        want = DA.decode_attention_plain(q.float(), k.float(), v.float(),
                                         valid, scale=scale)
        err = _held(got, want, "bfloat16", f"decode {arch}")
        row_err = _held_rows(got, want, f"decode {arch}")
        assert torch.equal(got, kern()), ("decode_attention rerun", arch)
        ms, eager_ms = _time_ms(kern, 50)
        nbytes = 2 * (2 * b * n_valid * kv * d + 2 * q.numel()) \
            + valid.numel()
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = 4.0 * b * h * n_valid * d / BF16_FLOPS * 1e3
        qT = q[:, :, None]
        kT, vT = (x.transpose(1, 2).contiguous() for x in (k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qT, kT, vT, attn_mask=valid[:, None, None, :], scale=scale,
            enable_gqa=True)
        sdpa_err = _held(got, sdpa()[:, :, 0], "bfloat16", f"sdpa {arch}")
        sdpa_ms, how = _graph_or_events(sdpa)
        rec = {"shape": [b, s, h, kv, d], "group": h // kv,
               "valid": n_valid, "ms": ms, "timed_by": "cuda graph replay",
               "eager_ms": eager_ms,
               "plain_ms": _event_ms(lambda: DA.decode_attention_plain(
                   q, k, v, valid, scale=scale), 5),
               "sdpa_ms": sdpa_ms, "sdpa_timed_by": how,
               "bound_ms": max(b_ms, o_ms),
               "bound_by": "bytes" if b_ms >= o_ms else "operations",
               "bound_share": max(b_ms, o_ms) / ms,
               "plan": plan._asdict(),
               "max_abs_err": err, "max_row_rel_err": row_err,
               "sdpa_max_abs_err": sdpa_err,
               "library_ms": sdpa_ms, "library": "sdpa"}
        other = "split" if plan.kernel == "group" else "group"
        if other == "split" or DA.group_takes(h // kv, d, bf):
            op = DA.decode_plan(b, s, h, kv, d, bf, kernel=other)
            run = lambda: DA._launch(op, q, k, v, valid,  # noqa: E731
                                     softcap=0.0, scale=scale)
            rec["other_plan"] = {
                "kernel": other, "plan": op._asdict(),
                "max_abs_err": _held(run(), want, "bfloat16",
                                     f"decode {other} {arch}"),
                "ms": _time_ms(run, 50)[0]}
            rec["other_plan"]["chosen_faster"] = \
                ms <= rec["other_plan"]["ms"]
        del want
        if with_flex:
            lib = _flex_call(qT, kT, vT, window=None, valid=valid,
                             scale=scale, cap=0.0)
            rec["flex_max_abs_err"] = _held(got, lib()[:, :, 0],
                                            "bfloat16", f"flex {arch}")
            rec["flex_ms"], rec["flex_timed_by"] = _graph_or_events(lib)
            rec["library_ms"], rec["library"] = rec["flex_ms"], "flex"
            del lib
        rec["kernel_faster"] = ms <= rec["library_ms"]
        decode[arch] = rec
        del q, k, v, qT, kT, vT, sdpa, got
        torch.cuda.empty_cache()
    return {"flash": flash, "decode": decode}


class _Spans:
    """CUDA events around every call of some module functions, for an
    eager run: the device ms between each call's start and end, summed
    by name (the stream's time, so a call the host cannot keep fed
    counts its gaps too).  ``targets``: name -> (module, attribute)."""

    def __init__(self, targets: dict):
        self.targets, self.events = targets, {n: [] for n in targets}

    def __enter__(self):
        import torch
        self.saved = {}
        for name, (mod, attr) in self.targets.items():
            fn = getattr(mod, attr)
            self.saved[name] = fn

            def timed(*a, _fn=fn, _ev=self.events[name], **kw):
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                out = _fn(*a, **kw)
                e.record()
                _ev.append((s, e))
                return out
            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.saved[name])

    def ms(self) -> dict:
        import torch
        torch.cuda.synchronize()
        return {n: {"calls": len(ev),
                    "ms": sum(a.elapsed_time(b) for a, b in ev)}
                for n, ev in self.events.items()}


def _kernel_groups(per: dict) -> dict:
    """Device us of a trace by kind of kernel: the port's attention
    kernels, matrix products (cuBLAS / CUTLASS), the rest."""
    out = {"flash_attention": 0.0, "decode_attention": 0.0, "gemm": 0.0,
           "other": 0.0}
    for name, us in per.items():
        low = name.lower()
        if "flash" in low:
            out["flash_attention"] += us
        elif "decode_" in low:
            out["decode_attention"] += us
        elif any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet",
                                    "sm90_")):
            out["gemm"] += us
        else:
            out["other"] += us
    return out


def _trace(fn) -> dict:
    """``fn()`` under torch.profiler (device activity only: a
    falcon-mamba prefill is ~31,000 kernels, and host events would
    double what the trace holds): wall ms, device busy ms, idle share,
    ms by kind of kernel and the heaviest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per, n_ops = _device_us(prof)
    busy = sum(per.values()) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "device_ops": n_ops,
            "ms_by_kind": {k: v / 1e3 for k, v in
                           _kernel_groups(per).items()},
            "top_device_us": [[k[:80], v] for k, v in top]}


def _family_breakdown(eng, cfg, grid) -> dict:
    """Where a prefill call and a decode step of ``eng`` spend their
    time: one prefill call of ``grid`` with CUDA events around each
    block mixer, flash call and associative scan (``_Spans``); another
    under torch.profiler, and one eager decode step from the engine's
    caches (device busy ms, idle share, ms by kind of kernel, the
    heaviest kernels)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe, rglru, ssm
    mixer = {"rec": (rglru, "apply_rglru"), "ssm": (ssm, "apply_ssm"),
             "moe_attn": (moe, "apply_moe"), "moe_local": (moe, "apply_moe")}
    targets = {"flash": (ops, "attention")}
    for kind in set(cfg.block_pattern):
        if kind in mixer:
            targets[mixer[kind][1]] = mixer[kind]
        if kind in ("rec", "ssm"):
            mod = rglru if kind == "rec" else ssm
            targets[f"associative_scan ({kind})"] = (mod, "associative_scan")

    def steps(n=1):
        for _ in range(n):
            eng._token.copy_(torch.from_numpy(
                np.full((grid.shape[0], 1), 7, np.int32)))
            with torch.no_grad():
                eng._decode()

    t0 = time.perf_counter()
    with _Spans(targets) as spans:
        eng._prefill(grid)
    rec = {"grid": list(grid.shape), "prefill_spans": spans.ms(),
           "spans_wall_ms": (time.perf_counter() - t0) * 1e3,
           "prefill_profile": _trace(lambda: eng._prefill(grid)),
           "eager_decode_step_profile": _trace(steps)}
    return rec


def _serve_family(device, arch: str, n_layers) -> dict:
    """One family's serve cell through ``ServingEngine`` (its decode
    step captured once), then the same tokens from an eager loop, the
    breakdown, and (with attention) the kernel path against the plain
    path at batch 1.  Frees the model before it returns."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    over = {"use_pallas": True}
    if n_layers:
        over["n_layers"] = n_layers
    cfg = dataclasses.replace(get_config(arch), **over)
    n_attn = _attn_layers(cfg)
    route = _kmod("flash_attention")._route(torch.bfloat16, cfg.head_dim)
    kern = _kmod("decode_attention").decode_plan(
        FAM_SLOTS, FAM_MAX_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        torch.bfloat16).kernel
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(T.param_defs(cfg), 0, torch.bfloat16, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServingEngine(cfg, params, ServeConfig(
        batch_slots=FAM_SLOTS, max_len=FAM_MAX_LEN, eos_token=-1),
        device=device)
    prompts = _family_prompts(cfg.vocab)
    calls = _timed(eng)
    torch.cuda.synchronize()
    reset_counts()
    t_start = t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=FAM_NEW)
    wall = time.perf_counter() - t0
    launches, by_route, by_plan = counts(), routes(), plans()
    peak = torch.cuda.max_memory_allocated()
    n_prefill, n_decode = len(calls["prefill"]), len(calls["decode"])
    prefill_s = sum(c[0] for c in calls["prefill"])
    decode_s = sum(c[0] for c in calls["decode"])
    prompt_tokens = sum(len(p) for p in prompts)
    rec = {"model": cfg.name, "layers": cfg.n_layers,
           "kinds": sorted(set(T.layer_kinds(cfg))),
           "attention_layers": n_attn, "params": T.n_params(params),
           "param_bytes": 2 * T.n_params(params), "dtype": "bfloat16",
           "init_s": init_s, "prompt_lengths": [len(p) for p in prompts],
           "stats": eng.stats, "wall_s": wall,
           "ttft_s": calls["prefill"][0][2] - t0,
           "prefill_s": [c[0] for c in calls["prefill"]],
           "prefill_tokens_per_s": prompt_tokens / prefill_s,
           "prefill_grid_tokens_per_s":
               sum(c[1] for c in calls["prefill"]) / prefill_s,
           "decode_step_ms": decode_s / n_decode * 1e3,
           "first_decode_step_ms": calls["decode"][0][0] * 1e3,
           "replayed_decode_step_ms": (decode_s - calls["decode"][0][0])
           / (n_decode - 1) * 1e3,
           "decode_tokens_per_s": FAM_SLOTS * n_decode / decode_s,
           "max_memory_allocated": peak, "captures": eng.captures,
           "launches": launches, "routes": by_route, "plans": by_plan,
           "flash_route": route if n_attn else None,
           "decode_kernel": kern if n_attn else None}
    assert eng.stats == {"prefills": 2, "refills": 0, "decode_steps": 30}, \
        (arch, eng.stats)
    assert all(len(o) == FAM_NEW for o in outs), arch
    assert eng.captures == 1, (arch, eng.captures)
    _expect(launches, arch, flash=n_attn * n_prefill,
            decode=n_attn * n_decode)
    _expect_routes(by_route, arch, **({route: n_attn * n_prefill}
                                      if n_attn else {}))
    _expect_plans(by_plan, arch, **({kern: n_attn * n_decode}
                                    if n_attn else {}))
    # the same tokens through an eager decode_step loop
    eager_outs, secs = _eager_serve(cfg, params, prompts, device,
                                    slots=FAM_SLOTS, max_len=FAM_MAX_LEN,
                                    new=FAM_NEW)
    rec["eager"] = {"decode_step_ms": sum(secs) / len(secs) * 1e3,
                    "decode_tokens_per_s": FAM_SLOTS * len(secs)
                    / sum(secs),
                    "tokens_equal_captured": eager_outs == outs}
    assert eager_outs == outs, f"{arch}: captured tokens differ from eager"
    steps_s = {"init": init_s, "generate": wall,
               "eager": time.perf_counter() - t_start - wall}
    grid = np.asarray([[0] * (FAM_PROMPT[1] - len(p)) + p
                       for p in prompts[:FAM_SLOTS]], np.int32)
    t0 = time.perf_counter()
    rec["breakdown"] = _family_breakdown(eng, cfg, grid)
    steps_s["breakdown"] = time.perf_counter() - t0
    del eng, calls
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if n_attn:
        gate_cfg, gate_params = cfg, params
        if cfg.moe is not None and cfg.n_layers > FAM_MOE_GATE_LAYERS:
            # top-k routing diverges with depth: the full depth is a
            # record, the gate runs on the model's first layers
            rec["kernel_vs_plain_batch1_full_depth"] = _kernel_vs_plain(
                params, cfg, _prompt_inputs(prompts[0], device), route,
                max_len=FAM_MAX_LEN)
            gate_cfg = dataclasses.replace(cfg, n_layers=FAM_MOE_GATE_LAYERS)
            gate_params = {**params,
                           "layers": params["layers"][:FAM_MOE_GATE_LAYERS]}
        rec["kernel_vs_plain_batch1"] = {
            "layers": gate_cfg.n_layers, **_kernel_vs_plain(
                gate_params, gate_cfg, _prompt_inputs(prompts[0], device),
                route, max_len=FAM_MAX_LEN)}
    steps_s["kernel_vs_plain"] = time.perf_counter() - t0
    rec["phase_seconds"] = steps_s
    del params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_family", **rec})
    cmp = rec.get("kernel_vs_plain_batch1", {})
    for tag in ("prefill", "decode"):
        if tag in cmp:
            c = cmp[tag]
            assert c["finite"] and c["rel"] <= SERVE_LOGIT_RTOL, \
                (arch, tag, c)
    return rec


def phase_serve_families(device) -> dict:
    """The attention shapes the families bring (``_family_attention``),
    then each family's serve cell in FAMILIES order, each model freed
    before the next is built (gemma2's ~67 GB were freed at the end of
    phase_serve)."""
    t0 = time.perf_counter()
    rec = {"phase": "serve_families", "attention": _family_attention(device),
           "logit_rtol": SERVE_LOGIT_RTOL, "models": {}}
    emit({"phase": "serve_families_attention", **rec["attention"]})
    for arch, n_layers in FAMILIES:
        rec["models"][arch] = _serve_family(device, arch, n_layers)
    rec["seconds"] = time.perf_counter() - t0
    emit({"phase": "serve_families", "seconds": rec["seconds"],
          "logit_rtol": SERVE_LOGIT_RTOL})
    return rec


# ---------------------------------------------------------------------------
# phase 17: the encoder-decoder and the VLM (whisper-base, internvl2-26b)
# ---------------------------------------------------------------------------

#: the two cells (the repo's configs at full size, bf16, random weights
#: from seed 0): whisper-base on 4 clips of stub frames, each with the
#: SOT prefix (<|startoftranscript|> <|en|> <|transcribe|>
#: <|notimestamps|>) as its prompt, 64 new tokens, a cache of whisper's
#: 448-token text context; internvl2-26b on 2 requests of 1024 stub
#: patches and 1024 random text tokens (joint prefills of 2048), 16 new
#: tokens, a cache of 2176.  Greedy, no EOS.
WHISPER_CLIPS, WHISPER_NEW, WHISPER_MAX_LEN = 4, 64, 448
WHISPER_SOT = (50258, 50259, 50359, 50363)
VLM_REQUESTS, VLM_TEXT, VLM_NEW, VLM_MAX_LEN = 2, 1024, 16, 2176
#: eager decode steps of the device profile
PROFILE_DECODE_STEPS = 3


def _stub_inputs(cfg, batch: int, text: int, dtype, device, seed: int = 0,
                 prompt=None):
    """A cell's inputs on ``device``: the stub frames or patches, shaped
    by ``configs.common.input_specs`` (its prefill cell) at ``batch``
    rows and drawn from ``seed``, and the prompt tokens: ``prompt`` in
    every row where given, else ``text`` random tokens a row."""
    import numpy as np
    import torch
    from repro_torch.configs import input_specs
    spec = input_specs(cfg, "prefill_32k")
    key = "frames" if cfg.encdec is not None else "patches"
    assert spec[key].device.type == "meta", spec[key]
    g = torch.Generator(device=device).manual_seed(seed)
    stub = torch.randn((batch, *spec[key].shape[1:]), generator=g,
                       device=device).to(dtype)
    if prompt is not None:
        toks = np.tile(np.asarray(prompt, np.int32), (batch, 1))
    else:
        toks = np.random.RandomState(seed).randint(
            2, cfg.vocab, (batch, text)).astype(np.int32)
    return {key: stub, "tokens": torch.from_numpy(toks).to(device)}


def _greedy(cfg, params, inputs, max_len: int, new: int, *,
            captured: bool = False, secs: list | None = None):
    """Greedy tokens (a list a row, ``new`` each) of a cell: one prefill,
    then ``new`` - 1 decode steps, issued eagerly or (``captured``) from
    one ``CapturedGraph`` capture, the first step warming up and
    capturing as the serving engine's does.  Every layer's cache counts
    on one device position (the engine's ``_pos``).  ``secs`` collects
    each step's seconds, token in to token on the host.  Returns (tokens,
    the graph's capture launches or None)."""
    import torch
    from repro_torch.kernels.capture import CapturedGraph, warm_up
    prefill, step = _model_fns(cfg, params, inputs, max_len)
    graph = None
    with torch.no_grad():
        logits, caches, extra = prefill()
        pos = torch.full((), _prompt_len(cfg, inputs), dtype=torch.int32,
                         device=logits.device)
        caches = [c._replace(pos=pos) for c in caches]
        token = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        del logits
        toks = [token[:, 0].tolist()]

        def fn():
            return step(token, caches, pos, extra)

        for _ in range(new - 1):
            t0 = time.perf_counter()
            if not captured:
                lg = fn()
            elif graph is None:
                lg = warm_up(fn)              # this step, for real
                graph = CapturedGraph(fn)
            else:
                graph.replay()
                lg = graph.out
            pos.add_(1)
            token.copy_(lg[:, 0].argmax(-1, keepdim=True))
            toks.append(token[:, 0].tolist())
            if secs is not None:
                secs.append(time.perf_counter() - t0)
        del caches, extra, lg
    launches = None
    if graph is not None:
        launches = graph.launches
        graph.release()
    return [list(row) for row in zip(*toks)], launches


def _serve_by_module(device, arch: str) -> dict:
    """One cell at full size in bf16: init, prefill time over two calls,
    greedy decode eager and from one capture (tokens equal), exact
    launches by route of a prefill call and a step, peak memory, a
    device profile of a prefill call and of PROFILE_DECODE_STEPS eager
    steps, and the kernel path against the plain path at batch 1.
    Frees the model before it returns."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import encdec, transformer, vlm
    from repro_torch.models.layers import init_params
    cfg = dataclasses.replace(get_config(arch), use_pallas=True)
    whisper = cfg.encdec is not None
    mod = encdec if whisper else vlm
    batch, text, new, max_len, prompt = (
        (WHISPER_CLIPS, None, WHISPER_NEW, WHISPER_MAX_LEN, WHISPER_SOT)
        if whisper else (VLM_REQUESTS, VLM_TEXT, VLM_NEW, VLM_MAX_LEN, None))
    n = cfg.n_layers
    route = _kmod("flash_attention")._route(torch.bfloat16, cfg.head_dim)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps_s = {}
    t0 = time.perf_counter()
    params = init_params(mod.param_defs(cfg), 0, torch.bfloat16,
                         device=device)
    torch.cuda.synchronize()
    steps_s["init"] = init_s = time.perf_counter() - t0
    inputs = _stub_inputs(cfg, batch, text, torch.bfloat16, device,
                          prompt=prompt)
    p = _prompt_len(cfg, inputs)
    prefill, step = _model_fns(cfg, params, inputs, max_len)
    # prefill: two calls (the second into the first's caches), timed
    # with the first token read on the host; one call's launches
    t0 = time.perf_counter()
    pf = []
    with torch.no_grad():
        caches = None
        for _ in range(2):
            reset_counts()
            t1 = time.perf_counter()
            logits, caches, extra = prefill(caches)
            logits[:, -1].argmax(-1).cpu()
            pf.append(time.perf_counter() - t1)
            launches, by_route = counts(), routes()
            _expect(launches, f"{arch} prefill", flash=n)
            _expect_routes(by_route, f"{arch} prefill", **{route: n})
        # one eager step's launches
        pos = torch.full((), p, dtype=torch.int32, device=device)
        caches = [c._replace(pos=pos) for c in caches]
        token = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        reset_counts()
        step(token, caches, pos, extra)
        torch.cuda.synchronize()
        step_launches = counts()
        _expect(step_launches, f"{arch} decode step", decode=n)
        _expect_routes(routes(), f"{arch} decode step")
        del logits, caches, extra
    steps_s["prefill"] = time.perf_counter() - t0
    # greedy decode: eager, then captured (one capture); equal tokens
    t0 = time.perf_counter()
    eager_secs, cap_secs = [], []
    eager, _ = _greedy(cfg, params, inputs, max_len, new, secs=eager_secs)
    reset_counts()
    cap, cap_launches = _greedy(cfg, params, inputs, max_len, new,
                                captured=True, secs=cap_secs)
    served, served_routes, served_plans = counts(), routes(), plans()
    peak = torch.cuda.max_memory_allocated()
    steps_s["decode"] = time.perf_counter() - t0
    # the captured run: a prefill, the warm-up step, new - 2 replays
    _expect(served, f"{arch} served", flash=n, decode=n * (new - 1))
    _expect_routes(served_routes, f"{arch} served", **{route: n})
    kern = _kmod("decode_attention").decode_plan(
        batch, max_len, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        torch.bfloat16).kernel
    _expect_plans(served_plans, f"{arch} served", **{kern: n * (new - 1)})
    merged = {k: v for d in cap_launches for k, v in d.items()}
    assert merged == {"decode_attention": n, kern: n}, (arch, cap_launches)
    replay_ms = sum(cap_secs[1:]) / len(cap_secs[1:]) * 1e3
    eager_ms = sum(eager_secs) / len(eager_secs) * 1e3
    n_params = transformer.n_params(params)
    rec = {"model": arch, "layers": n, "params": n_params,
           "param_bytes": 2 * n_params, "param_count_trunk":
           cfg.param_count(), "dtype": "bfloat16", "init_s": init_s,
           "batch": batch, "prompt_len": p, "new_tokens": new,
           "max_len": max_len, "route": route,
           "prefill_s": pf, "ttft_s": pf[0],
           "prefill_tokens_per_s": batch * p / pf[1],
           "prefill_launches": launches, "step_launches": step_launches,
           "replayed_decode_step_ms": replay_ms,
           "first_decode_step_ms": cap_secs[0] * 1e3,
           "eager_decode_step_ms": eager_ms,
           "decode_tokens_per_s": batch * (new - 1) / sum(cap_secs),
           "replayed_tokens_per_s": batch / replay_ms * 1e3,
           "served_launches": served, "served_routes": served_routes,
           "served_plans": served_plans, "decode_kernel": kern,
           "max_memory_allocated": peak,
           "tokens_equal_captured_eager": cap == eager,
           "tokens_row0": cap[0],
           "distinct_tokens": len({t for row in cap for t in row})}
    assert cap == eager, f"{arch}: captured tokens differ from eager"
    # the device profile: one prefill call, PROFILE_DECODE_STEPS eager steps
    t0 = time.perf_counter()
    with torch.no_grad():
        holder = {}

        def one_prefill():
            holder["out"] = prefill()
        rec["prefill_profile"] = _trace(one_prefill)
        logits, caches, extra = holder.pop("out")
        pos = torch.full((), p, dtype=torch.int32, device=device)
        caches = [c._replace(pos=pos) for c in caches]
        token = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)

        def steps():
            for _ in range(PROFILE_DECODE_STEPS):
                lg = step(token, caches, pos, extra)
                pos.add_(1)
                token.copy_(lg[:, 0].argmax(-1, keepdim=True))
                token.cpu()
        rec["eager_decode_profile"] = _trace(steps)
        rec["eager_decode_profile"]["steps"] = PROFILE_DECODE_STEPS
        del logits, caches, extra, holder
    steps_s["profile"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["kernel_vs_plain_batch1"] = _kernel_vs_plain(
        params, cfg, inputs, route, max_len)
    steps_s["kernel_vs_plain"] = time.perf_counter() - t0
    rec["phase_seconds"] = steps_s
    del params, inputs, prefill, step
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_encdec_vlm_model", **rec})
    for tag, c in rec["kernel_vs_plain_batch1"].items():
        assert c["finite"] and c["rel"] <= SERVE_LOGIT_RTOL, (arch, tag, c)
    return rec


def _whisper_f32(device) -> dict:
    """whisper-base at full size in float32: the kernel path's greedy
    tokens (captured decode) equal the plain path's; every flash launch
    on the CUDA-core route (d 64 in float32)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.models.layers import init_params
    cfg = dataclasses.replace(get_config("whisper-base"), dtype="float32",
                              use_pallas=True)
    n = cfg.n_layers
    params = init_params(encdec.param_defs(cfg), 0, torch.float32,
                         device=device)
    inputs = _stub_inputs(cfg, WHISPER_CLIPS, None, torch.float32, device,
                          prompt=WHISPER_SOT)
    toks, launches, by_route = {}, {}, {}
    for path, c in (("kernels", cfg),
                    ("plain", dataclasses.replace(cfg, use_pallas=False))):
        reset_counts()
        toks[path], _ = _greedy(c, params, inputs, WHISPER_MAX_LEN,
                                WHISPER_NEW, captured=True)
        launches[path], by_route[path] = counts(), routes()
    rec = {"model": "whisper-base", "dtype": "float32",
           "new_tokens": WHISPER_NEW, "tokens_equal":
           toks["kernels"] == toks["plain"], "launches": launches,
           "routes": by_route, "tokens_row0": toks["kernels"][0],
           "distinct_tokens": len({t for row in toks["kernels"]
                                   for t in row}),
           "kernel_vs_plain_batch1": _kernel_vs_plain(
               params, cfg, inputs, "cuda_core", WHISPER_MAX_LEN),
           "logit_rtol": SERVE_F32_LOGIT_RTOL}
    del params, inputs
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_encdec_vlm_f32", **rec})
    for tag, c in rec["kernel_vs_plain_batch1"].items():
        assert c["finite"] and c["rel"] <= SERVE_F32_LOGIT_RTOL, (tag, c)
    _expect(launches["kernels"], "whisper f32", flash=n,
            decode=n * (WHISPER_NEW - 1))
    _expect_routes(by_route["kernels"], "whisper f32", cuda_core=n)
    _expect(launches["plain"], "whisper f32 plain")
    assert rec["tokens_equal"], (toks["kernels"], toks["plain"])
    return rec


def phase_serve_encdec_vlm(device) -> dict:
    """whisper-base and internvl2-26b through their model modules'
    entry points at full size in bf16 (``_serve_by_module``), one after the
    other, each freed before the next; then whisper-base in float32
    against the plain path (``_whisper_f32``).  Runs after the families'
    phase has freed its models."""
    t0 = time.perf_counter()
    rec = {"phase": "serve_encdec_vlm", "logit_rtol": SERVE_LOGIT_RTOL,
           "models": {a: _serve_by_module(device, a)
                      for a in ("whisper-base", "internvl2-26b")}}
    rec["whisper_f32"] = _whisper_f32(device)
    rec["seconds"] = time.perf_counter() - t0
    emit({"phase": "serve_encdec_vlm", "seconds": rec["seconds"],
          "logit_rtol": SERVE_LOGIT_RTOL})
    return rec


# ---------------------------------------------------------------------------
# phase 19: the autotuning path (repro_torch.tune)
# ---------------------------------------------------------------------------

#: the tuning problem of benchmarks/tune_bench.py: paper-default DCQCN on
#: the CLOS incast of 8 senders (benchmarks/tune_bench.py's problem),
#: a trace sample every 50 steps; 1500 steps where the bench runs 3000,
#: so the script stays under half its time limit with the what-if, fleet
#: and pacer phases (the flows open at 1 ms, so 0.5 ms of them is tuned)
TUNE_STEPS = 1500
TUNE_TRACE = 50
TUNE_TAU = 0.2
#: benchmarks/tune_bench.py's ES_KW and the acceptance GradTuner settings
#: of tests/test_tune.py (iters=12, lr=0.25, temperature=0.2)
TUNE_ES_KW = dict(iters=4, pop=8, sigma=0.3, lr=0.4)
TUNE_GRAD_KW = dict(lr=0.25, temperature=0.2)
TUNE_GRAD_ITERS = 12
#: iters run here: each iteration is one eager value_and_grad (75-119 s
#: at 3000 steps on the H100), so the 12 of the acceptance test (13
#: calls) do not fit the script's time limit
TUNE_GRAD_ITERS_RUN = 1
#: the bitwise-resume check's problem: 3 senders, flows from 0; 50 steps
#: (100 before phase 17 came), one trace sample
TUNE_RESUME_STEPS = 50
#: steps of the temperature-0 check on the paper cell
TUNE_TAU0_STEPS = 2000


def _tune_problem():
    from repro_torch.core import CCScheme, PAPER_CONFIG, ScenarioSpec
    return PAPER_CONFIG.replace(scheme=CCScheme.DCQCN), \
        ScenarioSpec.incast(8)


def _soft_sweep():
    """tests/test_tune.py's small sweep: DCQCN and DCQCN-Rev on a
    4-sender incast with flows active 0.1 -> 1.1 ms."""
    from repro_torch.core import (CCScheme, PAPER_CONFIG, ScenarioSpec,
                                  Sweep)
    return Sweep.grid(
        configs={s.name: PAPER_CONFIG.replace(scheme=s)
                 for s in (CCScheme.DCQCN, CCScheme.DCQCN_REV)},
        scenarios={"in4": ScenarioSpec.incast(4, t_start=1e-4,
                                              t_stop=1.1e-3)})


def _rule_cases(device, g):
    """(name, wrapper(*leaves), plain(*leaves), leaves) for each kernel
    with an autograd rule, on random card tensors that require grad (the
    CC kernels' parameter rows among them)."""
    import torch
    from repro_torch.core import cc
    from repro_torch.core.fluid import step_params
    from repro_torch.core.params import CCSpec
    from repro_torch.kernels import cc_step as K
    from repro_torch.kernels import fluid_reduce as FR
    from repro_torch.kernels.ref import RPState
    R, F = 8, 4096
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        (R, F), generator=g, device=device)
    bern = lambda p: (torch.rand((R, F), generator=g, device=device)  # noqa
                      < p).float()
    par = step_params([CCSpec()] * R, device=device)
    dt = torch.tensor(1e-6, dtype=torch.float32, device=device)
    rows = cc.pack_react_rows(par.react, par.line_rate, dt)
    t_sec = u(0, 3e-3)[:, 0].contiguous()
    cases = []
    xs = [u(0, 4e6), u(0, 5e7), u(0, 1e6), u(0, 1e-4), u(0, 12.5e9),
          u(0, 2e-3), u(1e-3, 4e-3), u(0, 6e7), u(1e6, 4e6)]
    cases.append(("gen_np_step",
                  lambda *a: K.gen_np_step(*a, t_sec=t_sec, dt=dt),
                  lambda *a: K.gen_np_plain(
                      *a, K.pack_gen_np_params(t_sec, dt)), xs))
    cnp = bern(0.3)
    st = [u(1e6, 12.5e9), u(1e6, 12.5e9), u(0, 1), u(0, 1.2e7),
          u(0, 6e-5), u(0, 6e-5), torch.floor(u(0, 9)),
          torch.floor(u(0, 9))]
    cases.append(("rp_step",
                  lambda *a: tuple(K.rp_step(RPState(*a[:8]), cnp,
                                             packed=a[8])),
                  lambda *a: tuple(K.rp_plain(RPState(*a[:8]), cnp, a[8])),
                  st + [rows["rp"].clone()]))
    xs = [u(1e6, 12.5e9), u(0, 6e-5) * bern(0.5), u(1e6, 12.5e9),
          u(2.5e12, 7.5e12), rows["erp"].clone()]
    cases.append(("erp_step",
                  lambda *a: K.erp_step(a[0], a[1], cnp, a[2], a[3],
                                        packed=a[4]),
                  lambda *a: K.erp_plain(a[0], a[1], cnp, a[2], a[3], a[4]),
                  xs))
    xs = [u(1e6, 12.5e9), u(0, 5e-5) * bern(0.5), u(0, 1e-5),
          rows["swift"].clone()]
    cases.append(("swift_step",
                  lambda *a: K.swift_step(*a[:3], packed=a[3]),
                  lambda *a: K.swift_plain(*a), xs))
    # a segment walk over every other row of 3-channel data, segments of
    # 0-300 rows (short groups and long segments both)
    lens = torch.randint(0, 300, (400,), generator=g, device=device)
    off = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    n = int(off[-1])
    perm = torch.randperm(2 * n, generator=g, device=device)[:n]
    sched = FR.reduce_schedule(off)
    data = torch.randn((2 * n, 3), generator=g, device=device)
    cases.append(("segment_reduce",
                  lambda d: (FR.segment_reduce(d, None, 400, rows=perm,
                                               offsets=off,
                                               schedule=sched),),
                  lambda d: (FR.segment_reduce_plain(d, off, perm),),
                  [data]))
    return cases


def _rules_vs_plain(device) -> dict:
    """Each autograd rule on the card: the wrapper's forward (its kernel,
    one launch) and its gradient against the plain version's forward and
    autograd gradient on the same inputs and cotangents, bitwise."""
    import torch
    from repro_torch.tune.optimizers import deterministic
    g = torch.Generator(device=device).manual_seed(19)
    out = {}
    with deterministic(device):
        for name, kern, plain, leaves in _rule_cases(device, g):
            leaves = [x.detach().requires_grad_() for x in leaves]
            reset_counts()
            ko = kern(*leaves)
            launched = counts()[name]
            po = plain(*leaves)
            cot = [torch.randn(o.shape, generator=g, device=device)
                   for o in po]
            kg = torch.autograd.grad(ko, leaves, cot, allow_unused=True)
            pg = torch.autograd.grad(po, leaves, cot, allow_unused=True)
            z = lambda a, x: torch.zeros_like(x) if a is None else a  # noqa
            fwd = _max_abs_err(tuple(ko), tuple(po))
            grad = max(float((z(a, x) - z(b, x)).abs().max())
                       for a, b, x in zip(kg, pg, leaves))
            same = all(torch.equal(z(a, x), z(b, x))
                       for a, b, x in zip(kg, pg, leaves))
            nonzero = [bool(z(a, x).abs().max() > 0)
                       for a, x in zip(kg, leaves)]
            out[name] = {"launches": launched, "forward_max_abs_err": fwd,
                         "grad_bitwise_equal": same,
                         "grad_max_abs_err": grad,
                         "nonzero_grads": nonzero}
            assert launched == 1 and fwd == 0.0 and same, (name, out[name])
    return out


def _profile_soft(ev, theta, tau: float) -> dict:
    """Device busy time and idle share of one value_and_grad (forward and
    backward) by torch.profiler's kernel durations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.value_and_grad(theta, tau)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per, n_ops = _device_us(prof)
    steps = ev.n_samples * ev.k
    rec = {"profiled_steps": steps, "wall_ms_per_step": wall / steps * 1e3}
    if not per:
        rec["device"] = "not measured (the profiler saw no device events)"
        return rec
    busy = sum(per.values()) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    rec.update({"device_busy_ms_per_step": busy / steps * 1e3,
                "device_idle_share": 1.0 - busy / wall,
                "device_ops_per_step": n_ops / steps,
                "top_kernels_us_per_step": [[k[:80], v / steps]
                                            for k, v in top]})
    return rec


def _child(fn: str, *args, stdin: bool = False,
           card: bool = True) -> "subprocess.Popen":
    """Start ``chip_smoke.<fn>(*args)`` in a child process; its last
    stdout line is the JSON of what it returns (``_join``).  The soft
    rollout is host-bound (one core, the card ~96% idle), so the tune
    phase runs its long calls side by side in processes of their own.
    ``stdin``: a pipe the parent may write to (phase 21's go).
    ``card=False`` hides the card from the child (phase 22's dry run)."""
    code = (f"import json, sys; sys.path[:0] = [{SRC!r}, {HERE!r}]; "
            f"import chip_smoke as c; "
            f"print(json.dumps(c.{fn}(*json.loads(sys.argv[1]))))")
    env = None
    if not card:
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(args)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            stdin=subprocess.PIPE if stdin else None,
                            text=True, cwd=HERE, env=env)


def _join(proc, what: str, timeout: float = 900.0):
    """The JSON a ``_child`` printed last; raises if it failed."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n"
                           f"{err[-6000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _card():
    import torch
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def tune_cpu_refs() -> dict:
    """The CPU side of the tune phase's card-vs-CPU checks (a child
    process): the soft sweep's delivered bytes and the ``TUNE_STEPS``
    ``value_and_grad`` at theta0."""
    import torch
    from repro_torch.tune import Evaluator, TuneProblem
    torch.set_num_threads(2)
    res = _soft_sweep().run(900, device="cpu", temperature=TUNE_TAU)
    cfg, scn = _tune_problem()
    ev = Evaluator(TuneProblem(cfg, scn, n_steps=TUNE_STEPS,
                               trace_every=TUNE_TRACE, device="cpu"))
    t0 = time.perf_counter()
    val, grad = ev.value_and_grad(ev.box.encode(ev.spec), TUNE_TAU)
    return {"delivered": [res[i].final.delivered.tolist()
                          for i in range(len(res.points))],
            "value": val, "grad": grad.tolist(),
            "seconds": time.perf_counter() - t0}


def tune_value_and_grad() -> dict:
    """The tune cell's ``value_and_grad`` at theta0 once more (a child
    process on the card): the bitwise-repeat check's second call."""
    from repro_torch.tune import Evaluator, TuneProblem
    device = _card()
    cfg, scn = _tune_problem()
    ev = Evaluator(TuneProblem(cfg, scn, n_steps=TUNE_STEPS,
                               trace_every=TUNE_TRACE, device=device))
    t0 = time.perf_counter()
    val, grad = ev.value_and_grad(ev.box.encode(ev.spec), TUNE_TAU)
    return {"value": val, "grad": grad.tolist(),
            "seconds": time.perf_counter() - t0}


def tune_grad_autotune() -> dict:
    """``autotune(method="grad")`` at the acceptance settings, iters cut
    (a child process on the card)."""
    from repro_torch.tune import autotune
    device = _card()
    cfg, scn = _tune_problem()
    t0 = time.perf_counter()
    gr = autotune(cfg, scn, method="grad", n_steps=TUNE_STEPS,
                  trace_every=TUNE_TRACE, seed=0, device=device,
                  iters=TUNE_GRAD_ITERS_RUN, **TUNE_GRAD_KW)
    return {"kw": {**TUNE_GRAD_KW, "iters": TUNE_GRAD_ITERS_RUN},
            "iters_cut_from": TUNE_GRAD_ITERS,
            "cut_reason": f"one {TUNE_STEPS}-step eager value_and_grad an "
            "iteration on the card",
            "seconds": time.perf_counter() - t0,
            "trace_values": gr.trace.value.tolist(), **gr.to_record()}


def phase_tune(device, beside=None, last=None) -> dict:
    """The autotuning path: the soft model's temperature-0 identity and
    its card-vs-CPU agreement, ``value_and_grad`` through the kernels'
    autograd rules (bitwise repeatable, against the CPU, launches, ms a
    step forward and backward, peak memory, idle share), each rule
    against its plain version, ``autotune`` by ES and by gradient, and a
    killed-and-resumed GradTuner.  The CPU references, the gradient
    ``autotune`` and the second ``value_and_grad`` run in child
    processes beside the rest (the last two started after the timed
    call, so that call has the card alone).  ``beside()``, if given, runs
    in this process while those children finish; what it returns is
    ``rec["beside"]``.  ``last()``, if given, runs once only the gradient
    autotune child is left; what it returns is ``rec["last"]``."""
    from repro_torch.core import SWEEP_EXEC_CACHE
    t_phase = time.perf_counter()
    rec = {"phase": "tune"}
    children = [_child("tune_cpu_refs")]
    try:
        _phase_tune(device, rec, children, beside, last)
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "tune", "seconds": rec["seconds"]})
    SWEEP_EXEC_CACHE.clear()
    return rec


def _phase_tune(device, rec: dict, children: list, beside=None,
                last=None) -> None:
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import SWEEP_EXEC_CACHE, ScenarioSpec
    from repro_torch.tune import Evaluator, GradTuner, TuneProblem, autotune
    from repro_torch.tune.optimizers import deterministic

    # 1. temperature 0 builds the default run's window: a cache hit,
    #    bitwise equal, the same launches
    sweep = _paper_sweep()
    n = TUNE_TAU0_STEPS
    reset_counts()
    base = sweep.run(n, device=device)
    l_base = counts()
    s0 = SWEEP_EXEC_CACHE.stats()
    reset_counts()
    tau0 = sweep.run(n, device=device, temperature=0.0)
    l_tau0 = counts()
    d = SWEEP_EXEC_CACHE.stats() - s0
    rec["tau0"] = {"steps": n, "runs": len(sweep.points),
                   "bitwise_equal_default": _result_diff(tau0, base)[0],
                   "launches": l_tau0, "cache": d.to_dict()}
    emit({"phase": "tune", "check": "tau0", **rec["tau0"]})
    assert rec["tau0"]["bitwise_equal_default"], rec["tau0"]
    assert l_tau0 == l_base, (l_tau0, l_base)
    _launches_once_a_step(l_tau0, n, "tune tau0")
    assert (d.misses, d.hits) == (0, 1), d

    # 2. the soft model on the card (against the CPU below), refused on
    #    the kernel tiers
    small = _soft_sweep()
    t0 = time.perf_counter()
    card = small.run(900, device=device, temperature=TUNE_TAU)
    card_s = time.perf_counter() - t0
    hard = small.run(900, device=device)
    refused = {}
    for tier in (True, "mega"):
        try:
            small.run(64, device=device, temperature=TUNE_TAU,
                      use_kernels=tier)
            refused[str(tier)] = None
        except ValueError as e:
            refused[str(tier)] = "hard dynamics only" in str(e)
    assert all(refused.values()), refused
    moved = not _result_diff(card, hard)[0]
    assert moved, "the soft sweep equals the hard one"

    # 3. value_and_grad at theta0: forward and backward timed apart (the
    #    card to itself), launches of the forward, twice bitwise
    cfg, scn = _tune_problem()
    ev = Evaluator(TuneProblem(cfg, scn, n_steps=TUNE_STEPS,
                               trace_every=TUNE_TRACE, device=device))
    th0 = ev.box.encode(ev.spec)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    with deterministic(device):
        th = torch.tensor(th0, dtype=torch.float32, device=device,
                          requires_grad=True)
        t0 = time.perf_counter()
        val = ev.soft_objective(th, TUNE_TAU)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        l_fwd = counts()
        (grad,) = torch.autograd.grad(val, th)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    l_bwd = {k: v - l_fwd[k] for k, v in counts().items()}
    peak = torch.cuda.max_memory_allocated() - mem0
    v1, g1 = float(val.detach()), grad.double().cpu().numpy()
    del val, grad, th
    # the gradient autotune and the second value_and_grad (the bitwise
    # repeat) run in child processes beside checks 4-6: the rollout is
    # host-bound, one core a process
    children.append(_child("tune_grad_autotune"))
    children.append(_child("tune_value_and_grad"))
    steps = ev.n_samples * ev.k
    vag = {"steps": steps, "tau": TUNE_TAU, "theta": th0.tolist(),
           "value": v1, "grad": g1.tolist(),
           "forward_ms_per_step": (t1 - t0) / steps * 1e3,
           "backward_ms_per_step": (t2 - t1) / steps * 1e3,
           "value_and_grad_s": (t2 - t0), "peak_bytes": peak,
           "launches_forward": l_fwd, "launches_backward": l_bwd}
    short = Evaluator(TuneProblem(cfg, scn, n_steps=TUNE_TRACE,
                                  trace_every=TUNE_TRACE, device=device))
    vag["profile_beside_a_child"] = _profile_soft(short, th0, TUNE_TAU)
    rec["value_and_grad"] = vag
    # DCQCN alone: gen_np and rp once a step, three link sums a step on
    # segment_reduce (the rollout evaluates the config's stages only)
    want = {**{k: 0 for k in l_fwd}, "gen_np_step": steps,
            "rp_step": steps, "segment_reduce": 3 * steps}
    assert l_fwd == want, ("tune forward", l_fwd, want)
    assert not any(l_bwd.values()), l_bwd

    # 4. each autograd rule against its plain version's gradient
    rec["rules"] = _rules_vs_plain(device)
    emit({"phase": "tune", "check": "rules", "rules": rec["rules"]})

    # 5. autotune by ES on the hard model: one capture a population shape
    s0 = SWEEP_EXEC_CACHE.stats()
    t0 = time.perf_counter()
    es = autotune(cfg, scn, method="es", n_steps=TUNE_STEPS,
                  trace_every=TUNE_TRACE, seed=0, device=device,
                  **TUNE_ES_KW)
    es_s = time.perf_counter() - t0
    d = SWEEP_EXEC_CACHE.stats() - s0
    shapes = {TUNE_ES_KW["pop"], 1, len(es.candidates)}
    rec["es"] = {"kw": TUNE_ES_KW, "seconds_beside_a_child": es_s,
                 "population_shapes": sorted(shapes), "cache": d.to_dict(),
                 **es.to_record()}
    emit({"phase": "tune", "check": "autotune_es", **rec["es"]})
    assert es.improved, rec["es"]
    assert d.misses == len(shapes), (d, shapes)

    # 6. a GradTuner killed after 2 iterations and resumed = 4 straight
    small_ev = Evaluator(TuneProblem(
        cfg, ScenarioSpec.incast(3, t_start=0.0, t_stop=1.1e-3),
        n_steps=TUNE_RESUME_STEPS, trace_every=TUNE_TRACE, device=device))
    kw = dict(lr=0.2, temperature=0.3)
    t0 = time.perf_counter()
    full = GradTuner(iters=4, **kw).run(small_ev, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        GradTuner(iters=2, **kw).run(small_ev, seed=0, ckpt_dir=tmp,
                                     ckpt_every=2)
        resumed = GradTuner(iters=4, **kw).run(small_ev, seed=0,
                                               ckpt_dir=tmp)
    rec["resume"] = {"steps": TUNE_RESUME_STEPS, "iters": 4,
                     "killed_after": 2,
                     "seconds_beside_a_child": time.perf_counter() - t0,
                     "bitwise_equal": bool(
                         np.array_equal(full.theta, resumed.theta)
                         and np.array_equal(full.value, resumed.value)),
                     "values": full.value.tolist()}
    emit({"phase": "tune", "check": "resume", **rec["resume"]})
    assert rec["resume"]["bitwise_equal"], rec["resume"]
    assert not np.array_equal(full.theta[0], full.theta[-1]), full.theta

    # 2 and 3 against the CPU (the child's results)
    cpu = _join(children[0], "the tune phase's CPU references")
    rel = max(float(np.abs(card[i].final.delivered.astype(np.float64)
                           - np.asarray(want_d)).max()
                    / np.abs(np.asarray(want_d)).max())
              for i, want_d in enumerate(cpu["delivered"]))
    rec["soft_sweep"] = {"steps": 900, "tau": TUNE_TAU, "wall_s": card_s,
                         "delivered_rel_vs_cpu": rel,
                         "differs_from_hard": moved, "refused": refused}
    emit({"phase": "tune", "check": "soft_sweep", **rec["soft_sweep"]})
    assert rel <= 2e-3, rec["soft_sweep"]
    gcpu = np.asarray(cpu["grad"])
    cos = float(np.dot(g1, gcpu) / max(np.linalg.norm(g1)
                                       * np.linalg.norm(gcpu), 1e-300))
    vag.update({"cpu_value": cpu["value"], "cpu_grad": cpu["grad"],
                "cpu_s": cpu["seconds"],
                "value_rel_vs_cpu": abs(v1 - cpu["value"])
                / max(abs(cpu["value"]), 1e-30),
                "grad_cosine_vs_cpu": cos,
                "grad_norm_ratio_vs_cpu": float(np.linalg.norm(g1)
                                                / np.linalg.norm(gcpu))})
    emit({"phase": "tune", "check": "value_and_grad", **vag})
    assert vag["value_rel_vs_cpu"] <= 2e-3 and cos >= 0.99, vag

    if beside is not None:         # the children are host-bound
        rec["beside"] = beside()

    # 3 once more (the second child on the card): bitwise the first call
    again = _join(children[2], "the second value_and_grad")
    vag["second_call_s_in_a_child"] = again["seconds"]
    vag["bitwise_equal_twice"] = v1 == again["value"] and np.array_equal(
        g1, np.asarray(again["grad"], np.float64))
    emit({"phase": "tune", "check": "value_and_grad_twice",
          "bitwise_equal_twice": vag["bitwise_equal_twice"],
          "second_call_s_in_a_child": again["seconds"]})
    assert vag["bitwise_equal_twice"], (v1, again["value"])
    if last is not None:           # the gradient child is host-bound
        rec["last"] = last()

    # 7. autotune by gradient (the child on the card)
    rec["grad"] = _join(children[1], "autotune(method='grad')")
    emit({"phase": "tune", "check": "autotune_grad", **rec["grad"]})
    assert np.isfinite(rec["grad"]["best_value"]) and \
        rec["grad"]["best_value"] >= rec["grad"]["baseline_value"], \
        rec["grad"]
    # its first iteration is the call timed above: the same bits
    assert rec["grad"]["trace_values"][0] == v1, (rec["grad"], v1)


# ---------------------------------------------------------------------------
# phase 20: train
# ---------------------------------------------------------------------------

#: starcoder2-3b at full width, depth cut 30 -> 16: the functional step
#: holds two optimizer states (bf16 params, f32 master, mu, nu: 14 B a
#: param each) and the grads, ~32 B a param: 58.8 GB at depth 16, 102 GB
#: at 30 (the card holds 80)
TRAIN_ARCH = "starcoder2-3b"
TRAIN_LAYERS = 16
TRAIN_STEPS = 4
TRAIN_DATA = dict(seq_len=1024, global_batch=8, kind="zipf")
TRAIN_LOSS_CHUNK = 256
#: the card's dense bf16 peak (NVIDIA's data sheet, SXM, 700 W)
BF16_PEAK_FLOPS = 989e12
#: card against CPU (20c): starcoder2's smoke config in float32,
#: microbatches 2, int8 + EF compression, 5 steps from the same weights.
#: Each loss within 1e-4 relative; the params within 5e-2 of the
#: distance the CPU run moved them (L2), no element further than 2 lr a
#: step: AdamW's normalised steps turn a gradient within rounding of 0
#: (cuBLAS against the CPU's products) into opposite signs on a few
#: elements, as against the reference (tests/test_torch_train.py)
TRAIN_CVC_STEPS = 5
TRAIN_CVC_LR = 3e-3
TRAIN_CVC_LOSS_RTOL = 1e-4
TRAIN_CVC_PARAM_REL = 5e-2
#: exact resume (20d): examples/quickstart.py's model and step config
TRAIN_QS_STEPS = 20
TRAIN_QS_EVERY = 10


def _quickstart():
    from repro_torch.data import DataConfig
    from repro_torch.models import ModelConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import StepConfig
    cfg = ModelConfig(name="quickstart-3m", n_layers=4, d_model=128,
                      n_heads=4, n_kv_heads=2, head_dim=32, d_ff=512,
                      vocab=1024)
    sc = StepConfig(opt=AdamWConfig(lr=1e-2, weight_decay=0.01),
                    microbatches=2, compress_grads=True, warmup_steps=20,
                    total_steps=300)
    return cfg, sc, DataConfig(vocab=cfg.vocab, seq_len=128,
                               global_batch=8, kind="markov")


def _same_leaves(a, b) -> bool:
    """Every leaf of two trees (tensors or numpy arrays) bitwise equal,
    of one dtype."""
    import numpy as np
    import torch
    from repro_torch.optim._tree import leaves
    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x, y.to(x.device)):
                return False
        elif x.dtype != y.dtype or not np.array_equal(x, y):
            return False
    return True


def _finite(xs) -> bool:
    import math
    return all(math.isfinite(x) for x in xs)


#: kernel-name fragments of a training step's kinds of device work
TRAIN_KINDS = (("products", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
               ("softmax", ("softmax",)),
               ("reductions", ("reduce",)),
               ("index / embedding", ("index", "embedding", "sort",
                                      "scatter", "gather")),
               ("copies and casts", ("copy",)),
               ("elementwise", ("elementwise",)))


def _kinds_ms(per: dict) -> dict:
    """Device ms by kind of kernel (``TRAIN_KINDS``, first match by
    name; the rest as other)."""
    out = {k: 0.0 for k, _ in TRAIN_KINDS}
    out["other"] = 0.0
    for name, us in per.items():
        low = name.lower()
        kind = next((k for k, frags in TRAIN_KINDS
                     if any(f in low for f in frags)), "other")
        out[kind] += us / 1e3
    return out


def _train_full_width(device) -> dict:
    """(a) ``TRAIN_STEPS`` steps of starcoder2-3b at full width, depth
    ``TRAIN_LAYERS``, through ``train_loop``: ms a step, tokens/s, the
    model FLOP rate (6 x params x tokens over the step), the optimizer's
    share (CUDA events around ``adamw_update``), peak memory; then one
    more step under torch.profiler (device busy, idle share)."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import step as S
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS,
                              remat="full", loss_chunk=TRAIN_LOSS_CHUNK)
    assert not cfg.use_pallas
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc = S.StepConfig(opt=AdamWConfig())
    state = S.init_train_state(cfg, init_params(
        T.param_defs(cfg), 0, torch.bfloat16, device), sc)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = T.n_params(state.params)
    state_bytes = torch.cuda.memory_allocated()
    data = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    tokens = data.global_batch * data.seq_len
    logged, events = [], []
    update = S.adamw_update

    def timed_update(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = update(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    step = S.make_train_step(cfg, sc)
    # the loop's argument is the only reference to the first state, as a
    # step holds two states at once and three do not fit the card
    box = [state]
    del state
    S.adamw_update = timed_update
    try:
        reset_counts()
        out = train_loop(step, box.pop(), data,
                         TrainLoopConfig(total_steps=TRAIN_STEPS,
                                         log_every=1),
                         on_metrics=lambda s, m: logged.append(
                             (m["step_time"], float(m["grad_norm"]))))
        launches = counts()
    finally:
        S.adamw_update = update
    torch.cuda.synchronize()
    step_ms = [t * 1e3 for t, _ in logged]
    opt_ms = [a.elapsed_time(b) for a, b in events]
    steady = float(np.median(step_ms[1:]))
    flops = 6 * n_params * tokens
    rec = {"config": f"{TRAIN_ARCH} d {cfg.d_model}, {cfg.n_heads}/"
           f"{cfg.n_kv_heads} heads d {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
           f"{cfg.vocab}; {cfg.n_layers} of 30 layers; bf16 params + f32 "
           f"master; remat {cfg.remat}; loss_chunk {cfg.loss_chunk}",
           "params": n_params, "tokens_per_step": tokens,
           "data": {**TRAIN_DATA, "vocab": cfg.vocab}, "init_s": init_s,
           "state_bytes": state_bytes, "losses": out["losses"].tolist(),
           "grad_norms": [g for _, g in logged], "step_ms": step_ms,
           "steady_ms_per_step": steady,
           "tokens_per_s": tokens / (steady / 1e3),
           "model_flops_per_step": flops,
           "model_tflops_per_s": flops / (steady / 1e3) / 1e12,
           "share_of_bf16_peak": flops / (steady / 1e3) / BF16_PEAK_FLOPS,
           "optimizer_ms_per_step": opt_ms,
           "optimizer_share": float(np.median(opt_ms[1:])) / steady,
           "launches": launches,
           "peak_bytes_loop": torch.cuda.max_memory_allocated()}
    final = out.pop("state")
    batch = SyntheticLM(data).batch_at(TRAIN_STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new, m = step(final, batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
    del new, m, final
    gc.collect()
    torch.cuda.empty_cache()
    per, n_ops = _device_us(prof)
    prof_rec = {"wall_ms": wall * 1e3, "loss": loss, "device_ops": n_ops}
    if per:
        busy = sum(per.values()) / 1e3
        top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
        prof_rec.update({"device_busy_ms": busy,
                         "device_idle_share": 1.0 - busy / (wall * 1e3),
                         "device_ms_by_kind": _kinds_ms(per),
                         "top_device_ms": [[k[:80], v / 1e3]
                                           for k, v in top]})
    else:
        prof_rec["device"] = ("not measured (the profiler saw no device "
                              "events)")
    rec["profiled_step"] = prof_rec
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    return rec


def _train_remat_and_repeat(device) -> dict:
    """(b) the same width at depth 2: loss and gradients under remat
    none, full and dots bitwise equal; two 3-step runs from seed 0
    bitwise equal (losses and every leaf of the state)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim._tree import leaves, unflatten
    from repro_torch.train import step as S
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2,
                              loss_chunk=TRAIN_LOSS_CHUNK)
    data = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in SyntheticLM(data).batch_at(0).items()}
    params = init_params(T.param_defs(cfg), 0, torch.bfloat16, device)
    got = {}
    for remat in ("none", "full", "dots"):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        total, _ = T.loss_fn(unflatten(params, flat),
                             dataclasses.replace(cfg, remat=remat),
                             batch["tokens"], batch["labels"])
        got[remat] = (total.detach(), torch.autograd.grad(total, flat))
        del total, flat
    remat_equal = {r: bool(torch.equal(got[r][0], got["none"][0]) and all(
        torch.equal(a, b) for a, b in zip(got[r][1], got["none"][1])))
        for r in ("full", "dots")}
    loss = float(got["none"][0])
    del got, params
    sc = S.StepConfig(opt=AdamWConfig())
    cfg = dataclasses.replace(cfg, remat="full")

    def run():
        state = S.init_train_state(cfg, init_params(
            T.param_defs(cfg), 0, torch.bfloat16, device), sc)
        return train_loop(S.make_train_step(cfg, sc), state, data,
                          TrainLoopConfig(total_steps=3))

    a = run()
    b = run()
    repeat_equal = bool((a["losses"] == b["losses"]).all()) and \
        _same_leaves(a["state"], b["state"])
    rec = {"layers": 2, "loss": loss, "remat_bitwise_equal_none": remat_equal,
           "runs_bitwise_equal": repeat_equal,
           "losses": a["losses"].tolist()}
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _train_card_vs_cpu(device) -> dict:
    """(c) starcoder2's smoke config in float32 (TF32 off), microbatches 2
    and int8 + EF compression: ``TRAIN_CVC_STEPS`` steps on the card and
    on the CPU from the same weights."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim._tree import leaves
    from repro_torch.train import step as S
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    cfg = get_smoke_config(TRAIN_ARCH)
    sc = S.StepConfig(opt=AdamWConfig(lr=TRAIN_CVC_LR), microbatches=2,
                      compress_grads=True, warmup_steps=2,
                      total_steps=TRAIN_CVC_STEPS)
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8,
                      kind="markov")
    host = init_params(T.param_defs(cfg), 0, device="cpu")
    loop = TrainLoopConfig(total_steps=TRAIN_CVC_STEPS)
    step = S.make_train_step(cfg, sc)
    cpu = train_loop(step, S.init_train_state(cfg, host, sc), data, loop)
    card = train_loop(step, S.init_train_state(cfg, _to(host, device), sc),
                      data, loop)
    p0 = torch.cat([x.reshape(-1) for x in leaves(host)])
    pc = torch.cat([x.reshape(-1) for x in leaves(cpu["state"].params)])
    pg = torch.cat([x.reshape(-1).cpu()
                    for x in leaves(card["state"].params)])
    loss_rel = float(np.max(np.abs(card["losses"] - cpu["losses"])
                            / np.abs(cpu["losses"])))
    return {"config": f"{TRAIN_ARCH} smoke, float32, microbatches 2, "
            "compressed", "steps": TRAIN_CVC_STEPS,
            "losses_card": card["losses"].tolist(),
            "losses_cpu": cpu["losses"].tolist(), "loss_rel": loss_rel,
            "param_rel_l2": float((pg - pc).norm() / (pc - p0).norm()),
            "param_max_abs": float((pg - pc).abs().max()),
            "param_bound_abs": 2 * TRAIN_CVC_LR * TRAIN_CVC_STEPS,
            "keys_equal": bool(torch.equal(card["state"].rng,
                                           cpu["state"].rng))}


def _launcher_start(tmp: str) -> tuple:
    """The launcher (``python -m repro_torch.launch.train --smoke``) on the
    card: 20 steps with a checkpoint every 10 in this process; its
    directory copied without the step-20 checkpoint (a run killed after
    step 10), and a child process started to finish it with the
    launcher (``_launcher_finish`` compares)."""
    import shutil
    from repro_torch.ckpt import committed_steps
    from repro_torch.launch import train as launcher
    straight, killed = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    args = ["--arch", TRAIN_ARCH, "--smoke", "--steps", str(TRAIN_QS_STEPS),
            "--ckpt-every", str(TRAIN_QS_EVERY), "--log-every", "10"]
    t0 = time.perf_counter()
    launcher.main(args + ["--ckpt-dir", straight])
    st = {"straight": straight, "killed": killed,
          "in_process_s": time.perf_counter() - t0}
    assert committed_steps(straight) == [TRAIN_QS_EVERY, TRAIN_QS_STEPS]
    shutil.copytree(straight, killed)
    last = os.path.join(killed, f"step_{TRAIN_QS_STEPS:09d}")
    shutil.rmtree(last)
    os.remove(last + ".done")
    st["t0"] = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--ckpt-dir", killed], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=SRC))
    return proc, st


def _launcher_finish(proc, st: dict) -> dict:
    """The child's step-20 checkpoint against the uninterrupted run's:
    bitwise equal, every leaf and the data step."""
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.train.loop import NT_REGISTRY
    out, err = proc.communicate(timeout=600)
    child_s = time.perf_counter() - st["t0"]
    if proc.returncode != 0:
        raise RuntimeError(f"the launcher's resume failed (exit "
                           f"{proc.returncode}):\n{err[-4000:]}")
    want, extra_w = load_checkpoint(st["straight"], TRAIN_QS_STEPS,
                                    nt_registry=NT_REGISTRY)
    got, extra_g = load_checkpoint(st["killed"], TRAIN_QS_STEPS,
                                   nt_registry=NT_REGISTRY)
    return {"in_process_s": st["in_process_s"], "child_s": child_s,
            "child_resumed_at": TRAIN_QS_EVERY,
            "child_tail": out.strip().splitlines()[-2:],
            "bitwise_equal": _same_leaves(got, want)
            and extra_w == extra_g}


def _train_resume(device) -> dict:
    """(d) examples/quickstart.py's model (quickstart-3m, microbatches 2,
    compression on) on the card: 20 straight steps against 10 with a
    checkpoint and a resumed run to 20; a ``stop_flag`` save after 4 and a
    resume to 20.  Every resumed state bitwise the uninterrupted run's.
    (The launcher's resume: ``_launcher_start`` / ``_launcher_finish``.)"""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.ckpt import latest_step
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.train import step as S
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    cfg, sc, data = _quickstart()
    state0 = S.init_train_state(cfg, init_params(
        T.param_defs(cfg), 0, torch.float32, device), sc)
    step = S.make_train_step(cfg, sc)
    t0 = time.perf_counter()
    straight = train_loop(step, state0, data,
                          TrainLoopConfig(total_steps=TRAIN_QS_STEPS))
    straight_s = time.perf_counter() - t0
    rec = {"config": "quickstart-3m, microbatches 2, compressed",
           "steps": TRAIN_QS_STEPS, "straight_s": straight_s,
           "losses": straight["losses"].tolist()}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "resume")
        first = train_loop(step, state0, data, TrainLoopConfig(
            total_steps=TRAIN_QS_EVERY, ckpt_dir=ck,
            ckpt_every=TRAIN_QS_EVERY))
        second = train_loop(step, state0, data, TrainLoopConfig(
            total_steps=TRAIN_QS_STEPS, ckpt_dir=ck,
            ckpt_every=TRAIN_QS_EVERY))
        rec["resumed_bitwise_equal"] = bool(np.array_equal(
            np.concatenate([first["losses"], second["losses"]]),
            straight["losses"])) and _same_leaves(second["state"],
                                                  straight["state"])
        ck = os.path.join(tmp, "stop")
        calls = {"n": 0}

        def stop_flag():
            calls["n"] += 1
            return calls["n"] >= 4

        stopped = train_loop(step, state0, data, TrainLoopConfig(
            total_steps=TRAIN_QS_STEPS, ckpt_dir=ck, ckpt_every=1000),
            stop_flag=stop_flag)
        saved = latest_step(ck)
        after = train_loop(step, state0, data, TrainLoopConfig(
            total_steps=TRAIN_QS_STEPS, ckpt_dir=ck, ckpt_every=1000))
        rec["stop_flag"] = {"final_step": stopped["final_step"],
                            "saved_step": saved,
                            "resumed_bitwise_equal": _same_leaves(
                                after["state"], straight["state"])}
    return rec


def _train_refuses_kernels(device) -> dict:
    """(e) starcoder2's smoke config at depth 2 on the card: a loss under
    autograd with ``use_pallas=True`` raises (the kernels have no
    backward); without autograd the kernel path's loss is the plain
    path's (2 flash launches); with ``use_pallas=False`` every leaf gets
    a finite gradient."""
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim._tree import leaves, paths, unflatten
    cfg = dataclasses.replace(get_smoke_config(TRAIN_ARCH), n_layers=2)
    kern = dataclasses.replace(cfg, use_pallas=True)
    params = init_params(T.param_defs(cfg), 0, device=device)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                   global_batch=4)).batch_at(0)
    tok, lab = (torch.from_numpy(batch[k]).to(device)
                for k in ("tokens", "labels"))
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    reset_counts()
    try:
        T.loss_fn(unflatten(params, flat), kern, tok, lab)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    refused_launches = counts()
    reset_counts()
    with torch.no_grad():
        lk, _ = T.loss_fn(params, kern, tok, lab)
        lp, _ = T.loss_fn(params, cfg, tok, lab)
    no_grad_launches = counts()
    total, _ = T.loss_fn(unflatten(params, flat), cfg, tok, lab)
    grads = torch.autograd.grad(total, flat)
    names = ["/".join(map(str, p)) for p in paths(params)]
    zero = [n for n, g in zip(names, grads) if not bool(g.abs().sum() > 0)]
    return {"refused": refused, "launches_refused": refused_launches,
            "no_grad_loss_kernel": float(lk), "no_grad_loss_plain": float(lp),
            "no_grad_launches": no_grad_launches,
            "leaves": len(grads),
            "finite": all(bool(torch.isfinite(g).all()) for g in grads),
            "zero_grad_leaves": zero}


def train_checks(device) -> dict:
    """Phase 20's checks (b)-(e), under deterministic algorithms (the
    embedding's and ``gather``'s backward accumulate with ``index_put_``
    / ``scatter_add_``) but (e).  None is timed: they run while the tune
    phase waits on its host-bound children, the launcher's resume in a
    child of its own beside (b)-(d)."""
    import tempfile
    from repro_torch.tune.optimizers import deterministic
    rec = {}
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, deterministic(device):
        proc, st = _launcher_start(tmp)
        try:
            t0 = time.perf_counter()
            rec["remat"] = b = _train_remat_and_repeat(device)
            b["seconds"] = time.perf_counter() - t0
            emit({"phase": "train", "check": "remat_and_repeat", **b})
            assert all(b["remat_bitwise_equal_none"].values()), b
            assert b["runs_bitwise_equal"], b
            t0 = time.perf_counter()
            rec["card_vs_cpu"] = c = _train_card_vs_cpu(device)
            c["seconds"] = time.perf_counter() - t0
            emit({"phase": "train", "check": "card_vs_cpu", **c})
            assert c["loss_rel"] <= TRAIN_CVC_LOSS_RTOL, c
            assert c["param_rel_l2"] <= TRAIN_CVC_PARAM_REL, c
            assert c["param_max_abs"] <= c["param_bound_abs"], c
            assert c["keys_equal"], c
            t0 = time.perf_counter()
            rec["resume"] = d = _train_resume(device)
            d["seconds"] = time.perf_counter() - t0
            d["launcher"] = _launcher_finish(proc, st)
            emit({"phase": "train", "check": "resume", **d})
            assert d["resumed_bitwise_equal"], d
            assert d["stop_flag"]["final_step"] == \
                d["stop_flag"]["saved_step"] == 4, d
            assert d["stop_flag"]["resumed_bitwise_equal"], d
            assert d["launcher"]["bitwise_equal"], d["launcher"]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    t0 = time.perf_counter()
    rec["refusal"] = e = _train_refuses_kernels(device)
    e["seconds"] = time.perf_counter() - t0
    emit({"phase": "train", "check": "kernels_refuse_autograd", **e})
    assert e["refused"] and "no backward" in e["refused"], e
    assert not any(e["launches_refused"].values()), e
    assert e["no_grad_launches"]["flash_attention"] == 2, e
    assert abs(e["no_grad_loss_kernel"] - e["no_grad_loss_plain"]) <= \
        1e-4 * abs(e["no_grad_loss_plain"]), e
    assert e["finite"] and not [n for n in e["zero_grad_leaves"]
                                if "/attn/w" in n], e
    rec["seconds"] = time.perf_counter() - t_all
    return rec


def phase_train(device, checks: dict) -> dict:
    """Phase 20, the training path (``repro_torch.train``): (a) on a quiet
    card, under deterministic algorithms, after (b)-(e) (``checks``, run
    beside the tune phase's children)."""
    from repro_torch.tune.optimizers import deterministic
    t_phase = time.perf_counter()
    rec = {"phase": "train", "nvidia_smi": nvidia_smi(), **checks}
    with deterministic(device):
        rec["full_width"] = a = _train_full_width(device)
    a["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "train", "check": "full_width",
          "nvidia_smi": rec["nvidia_smi"], **a})
    assert _finite(a["losses"]) and _finite(a["grad_norms"]), a
    assert len(a["losses"]) == TRAIN_STEPS, a
    assert not any(a["launches"].values()), a["launches"]
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "train", "seconds": rec["seconds"],
          "checks_beside_tune_s": checks["seconds"]})
    return rec


# ---------------------------------------------------------------------------
# phase 21: the sharded Sweep, pipeline_apply and the elastic restore
# ---------------------------------------------------------------------------

#: (c): examples/paced_collectives.py's layer width, four stages of
#: tanh(x @ W + b) over 8 microbatches of 64 rows, held to the CPU within
#: PIPE_CPU_RTOL of the largest output
PIPE_STAGES, PIPE_WIDTH, PIPE_MICRO, PIPE_ROWS = 4, 1024, 8, 64
PIPE_CPU_RTOL = 1e-5
#: (b): the reference's two-device case (tests/test_sharded_sweep.py):
#: the paper incast, 3 schemes x roll 0, 300 steps, 3 runs padded to 4
SHARD_PAPER_STEPS = 300
#: (d): the starcoder2 smoke config's float32 state, saved at this step
#: and resumed one step further, plainly and onto the host mesh
ELASTIC_SAVE_AT = 3


def _digests(res) -> dict:
    """sha256 of each trace field and final-state leaf of a result (its
    dtype and shape first): two results are bitwise equal exactly when
    every digest is."""
    import hashlib
    import numpy as np
    out = {}
    for name, x in _leaves(res):
        x = np.ascontiguousarray(x)
        h = hashlib.sha256(f"{x.dtype}{x.shape}".encode())
        h.update(x.tobytes())
        out[name] = h.hexdigest()
    return out


def _differing(got: dict, want: dict) -> list:
    return sorted(k for k in set(got) | set(want)
                  if got.get(k) != want.get(k))


def _time_gathers() -> list:
    """Wrap the sharded Sweep's gather so each call's seconds (after the
    card has finished the run it gathers) land in the returned list."""
    import torch
    from repro_torch.core import experiments as E
    inner, spent = E._gather_runs, []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)
        spent.append(time.perf_counter() - t0)
        return out

    E._gather_runs = timed
    return spent


def _sharded_run(sweep, mesh, kw: dict, gathers: list, barrier=None):
    """One timed ``Sweep.run(mesh=)`` of the dc depth after a warm-up at
    the check depth (which builds this rank's window entry): wall s,
    gather s, peak memory, launches, the result's digests."""
    import torch
    sweep.run(DC_CHECK_STEPS, trace_every=100, mesh=mesh, **kw)
    if barrier is not None:
        barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gathers.clear()
    reset_counts()
    t0 = time.perf_counter()
    res = sweep.run(DC_STEPS, trace_every=100, mesh=mesh, **kw)
    wall = time.perf_counter() - t0
    return {"sharded_s": wall, "gather_s": sum(gathers),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": counts()}, _digests(res)


def sharded_world_of_one(want: dict) -> dict:
    """Phase 21 (a), a child process: after the parent's go on stdin,
    the dc sweep through ``Sweep.run(mesh=sweep_mesh(1))`` on the card,
    flow and mega tiers, against one launch of each timed in the same
    process and against the dc phase's result (``want``, its digests);
    then the mega tier once more in a world of one over NCCL, where the
    gather packs and all-gathers its buffer on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sweep_mesh
    gathers = _time_gathers()
    sweep = _dc_sweep()
    sys.stdin.readline()            # the card to ourselves from here
    device = _card()
    mesh = sweep_mesh(1)
    rec = {"world": dist.get_world_size(), "mesh": str(mesh),
           "mesh_device_type": mesh.device_type, "runs": len(sweep.points)}
    try:
        for tier, kw in (("flow", {}), ("mega", MEGA)):
            sweep.run(DC_CHECK_STEPS, trace_every=100, device=device, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = sweep.run(DC_STEPS, trace_every=100, device=device, **kw)
            one_s = time.perf_counter() - t0
            one = _digests(one)
            r, got = _sharded_run(sweep, mesh, kw, gathers)
            r.update({"one_launch_s": one_s,
                      "overhead": r["sharded_s"] / one_s - 1,
                      "bitwise_equal_one_launch": got == one,
                      "bitwise_equal_dc_phase": got == want,
                      "differing": _differing(got, want)[:8]})
            rec[tier] = r
    finally:
        dist.destroy_process_group()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = sweep_mesh(1)
        r, got = _sharded_run(sweep, mesh, MEGA, gathers)
        r.update({"backend": dist.get_backend(mesh.get_group(0)),
                  "bitwise_equal_dc_phase": got == want,
                  "differing": _differing(got, want)[:8]})
        rec["nccl_mega"] = r
    finally:
        dist.destroy_process_group()
    return rec


def _shard_paper_sweep():
    from repro_torch.core import CCScheme, PAPER_CONFIG, ScenarioSpec, Sweep
    return Sweep.grid(
        configs={s.name: PAPER_CONFIG.replace(scheme=s) for s in CCScheme},
        scenarios={"hol": ScenarioSpec.paper_incast(roll=0)})


def sharded_rank(rank: int, port: int, want: dict) -> dict:
    """Phase 21 (b), one of two child processes sharing the card over
    gloo: after the parent's go on stdin, the dc sweep through a mesh of
    two ranks (18 runs a rank), flow and mega tiers, against the dc
    phase's result; then the reference's two-device case (the paper
    incast, 3 runs padded to 4) against its one launch on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sweep_mesh
    gathers = _time_gathers()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        sweep = _dc_sweep()
        sys.stdin.readline()        # the card to ourselves from here
        device = _card()
        mesh = sweep_mesh()
        rec = {"rank": rank, "world": dist.get_world_size(),
               "mesh": str(mesh), "device": str(torch.cuda.current_device()),
               "runs": len(sweep.points)}
        for tier, kw in (("flow", {}), ("mega", MEGA)):
            r, got = _sharded_run(sweep, mesh, kw, gathers, dist.barrier)
            r.update({"bitwise_equal_dc_phase": got == want,
                      "differing": _differing(got, want)[:8]})
            rec[tier] = r
        paper = _shard_paper_sweep()
        one = _digests(paper.run(SHARD_PAPER_STEPS, device=device))
        got = _digests(paper.run(SHARD_PAPER_STEPS, mesh=mesh))
        rec["paper"] = {"runs": len(paper.points), "padded_to": 4,
                        "steps": SHARD_PAPER_STEPS,
                        "bitwise_equal_one_launch": got == one,
                        "differing": _differing(got, one)[:8]}
    finally:
        dist.destroy_process_group()
    return rec


def _pipeline_on_card(device) -> dict:
    """(c) ``pipeline_apply`` of ``PIPE_STAGES`` stages on the card:
    bitwise the stages back to back there, within ``PIPE_CPU_RTOL`` of
    the CPU (relative to the largest output)."""
    import numpy as np
    import torch
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1,), ("pod",))
    g = np.random.default_rng(0)
    S, D = PIPE_STAGES, PIPE_WIDTH
    host = {"w": torch.from_numpy((g.standard_normal((S, D, D))
                                   / np.sqrt(D)).astype(np.float32)),
            "b": torch.from_numpy((0.1 * g.standard_normal((S, D)))
                                  .astype(np.float32))}
    xs = torch.from_numpy(g.standard_normal(
        (PIPE_MICRO, PIPE_ROWS, D)).astype(np.float32))
    card = {k: v.to(device) for k, v in host.items()}
    xc = xs.to(device)

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    pipeline_apply(stage, card, xc, mesh, n_stages=S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline_apply(stage, card, xc, mesh, n_stages=S)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    seq = []
    for x in xc.unbind(0):
        for s in range(S):
            x = stage({k: v[s] for k, v in card.items()}, x)
        seq.append(x)
    cpu = pipeline_apply(stage, host, xs, mesh, n_stages=S)
    rel = float((out.cpu() - cpu).abs().max() / cpu.abs().max())
    return {"stages": S, "width": D, "microbatches": PIPE_MICRO,
            "rows": PIPE_ROWS, "mesh": str(mesh), "ms": ms,
            "bitwise_equal_back_to_back": bool(torch.equal(
                out, torch.stack(seq))),
            "max_rel_err_cpu": rel, "rtol": PIPE_CPU_RTOL}


def _placed(tree, shardings, out: list) -> list:
    """(leaf, its NamedSharding) pairs of a state and its shardings."""
    from repro_torch.dist.sharding import NamedSharding
    if isinstance(shardings, NamedSharding):
        out.append((tree, shardings))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _placed(tree[k], shardings[k], out)
    elif shardings is not None:
        for a, b in zip(tree, shardings):
            _placed(a, b, out)
    return out


def _elastic_restore(device, tmp: str) -> dict:
    """(d) the starcoder2 smoke config's float32 train state saved at
    step ``ELASTIC_SAVE_AT``, restored onto ``logical_sharding`` of
    ``train_state_specs`` on ``make_host_mesh()`` (placements, values)
    and resumed through ``train_loop(state_shardings=)`` one step: its
    loss and state bitwise the unsharded resume's."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.dist.sharding import tree_shardings
    from repro_torch.launch.mesh import describe, make_host_mesh
    from repro_torch.models import param_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim._tree import leaves
    from repro_torch.train import train_state_specs
    from repro_torch.train import step as S
    from repro_torch.train.loop import NT_REGISTRY, TrainLoopConfig, \
        train_loop
    cfg = get_smoke_config(TRAIN_ARCH)
    defs = T.param_defs(cfg)
    sc = S.StepConfig(opt=AdamWConfig(lr=3e-3), warmup_steps=5,
                      total_steps=100)
    state = S.init_train_state(cfg, init_params(defs, 0, torch.float32,
                                                device), sc)
    step = S.make_train_step(cfg, sc)
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                      kind="zipf")
    n = ELASTIC_SAVE_AT
    train_loop(step, state, data, TrainLoopConfig(
        total_steps=n, ckpt_dir=tmp, ckpt_every=n))
    ref = train_loop(step, state, data, TrainLoopConfig(
        total_steps=n + 1, ckpt_dir=tmp, ckpt_every=100))
    mesh = make_host_mesh()
    sh = tree_shardings(train_state_specs(cfg, param_specs(defs), sc),
                        state, mesh)
    placed, _ = load_checkpoint(tmp, shardings=sh._replace(rng=None),
                                nt_registry=NT_REGISTRY)
    plain, _ = load_checkpoint(tmp, device=device, nt_registry=NT_REGISTRY)
    pairs = _placed(placed._replace(rng=None), sh._replace(rng=None), [])
    placements = all(isinstance(x, DTensor) and x.placements == s.placements
                     for x, s in pairs)
    values = all(torch.equal(x.full_tensor(), y) for x, y in zip(
        leaves(placed._replace(rng=None)), leaves(plain._replace(rng=None))))
    t0 = time.perf_counter()
    out = train_loop(step, state, data, TrainLoopConfig(
        total_steps=n + 1, ckpt_dir=tmp, ckpt_every=100),
        state_shardings=sh)
    step_s = time.perf_counter() - t0
    state_bitwise = all(
        torch.equal(x.full_tensor() if isinstance(x, DTensor) else x, y)
        for x, y in zip(leaves(out["state"]), leaves(ref["state"])))
    return {"arch": cfg.name, "mesh": describe(mesh),
            "leaves": len(pairs), "saved_at": n,
            "placements_as_asked": placements,
            "shard_placements": sorted({str(s.placements) for _, s in pairs}),
            "values_bitwise": values,
            "loss_sharded": out["losses"].tolist(),
            "loss_unsharded": ref["losses"].tolist(),
            "loss_bitwise": bool(np.array_equal(out["losses"],
                                                ref["losses"])),
            "state_bitwise": state_bitwise,
            "resume_s": step_s}


def sharded_checks() -> dict:
    """Phase 21 (c) and (d), a child process with a world of one on the
    card (deterministic algorithms for (d))."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.tune.optimizers import deterministic
    device = _card()
    rec = {}
    try:
        t0 = time.perf_counter()
        rec["pipeline"] = _pipeline_on_card(device)
        rec["pipeline"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, deterministic(device):
            rec["elastic"] = _elastic_restore(device, tmp)
        rec["elastic"]["seconds"] = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return rec


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_children(want: dict) -> list:
    """Phase 21's (a) child and (b)'s two ranks, started beside the tune
    phase's checks: each imports, builds the dc sweep (and (b) joins its
    process group) on the host, then waits for a go on stdin before it
    touches the card (``sharded_runs``)."""
    port = _free_port()
    return [_child("sharded_world_of_one", want, stdin=True)] + [
        _child("sharded_rank", r, port, want, stdin=True) for r in (0, 1)]


def _go(*procs) -> None:
    for proc in procs:
        try:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        except BrokenPipeError:         # it failed: _join says how
            pass


def _stop(procs) -> None:
    """Kill whichever of ``procs`` still runs."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def sharded_runs(children: list) -> dict:
    """Phase 21 (a), then (b) (``children``, from ``sharded_children``),
    each gated bitwise: run while the tune phase waits on its gradient
    autotune child (one host-bound process; the card ~96% idle).
    Returns the record with each rank's launches."""
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()        # the parent's pool, for the children
    one, *ranks = children
    _go(one)
    a = _join(one, "sharded_world_of_one")
    _go(*ranks)
    b = [_join(p, f"sharded_rank {r}") for r, p in enumerate(ranks)]
    for tier, n_cc, n_block in (("flow", DC_STEPS, 0),
                                ("mega", 0, DC_STEPS // 100)):
        emit({"phase": "sharded_sweep", "case": f"world_of_one_{tier}",
              **a[tier]})
        for r in b:
            r[tier]["overhead"] = r[tier]["sharded_s"] / \
                a[tier]["one_launch_s"] - 1
            emit({"phase": "sharded_sweep", "case": f"rank{r['rank']}_{tier}",
                  "one_launch_s": a[tier]["one_launch_s"], **r[tier]})
        assert a[tier]["bitwise_equal_one_launch"], (tier, a[tier])
        assert a[tier]["bitwise_equal_dc_phase"], (tier, a[tier])
        _expect(a[tier]["launches"], f"sharded world of one {tier}",
                cc=n_cc, block=n_block)
        for r in b:
            assert r[tier]["bitwise_equal_dc_phase"], (r["rank"], tier,
                                                        r[tier])
            _expect(r[tier]["launches"], f"sharded rank {r['rank']} {tier}",
                    cc=n_cc, block=n_block)
    n = a["nccl_mega"]
    n["overhead"] = n["sharded_s"] / a["mega"]["one_launch_s"] - 1
    emit({"phase": "sharded_sweep", "case": "world_of_one_nccl_mega",
          "one_launch_s": a["mega"]["one_launch_s"], **n})
    assert n["backend"] == "nccl" and n["bitwise_equal_dc_phase"], n
    _expect(n["launches"], "sharded world of one over nccl, mega",
            block=DC_STEPS // 100)
    for r in b:
        emit({"phase": "sharded_sweep", "case": f"rank{r['rank']}_paper",
              **r["paper"]})
        assert r["paper"]["bitwise_equal_one_launch"], r["paper"]
    return {"world_of_one": a, "two_ranks": b,
            "seconds": time.perf_counter() - t0}


def phase_sharded_sweep(checks: dict, runs: dict) -> dict:
    """Phase 21: (a) and (b) (``runs``, from ``sharded_runs``, gated
    there, during the tune phase's wait), (c) and (d) (``checks``, a
    child beside the tune phase) gated here."""
    t_phase = time.perf_counter()
    rec = {"phase": "sharded_sweep", "nvidia_smi": nvidia_smi(), **runs}
    rec.update(checks)
    emit({"phase": "sharded_sweep", "case": "pipeline", **checks["pipeline"]})
    emit({"phase": "sharded_sweep", "case": "elastic_restore",
          **checks["elastic"]})
    p, e = checks["pipeline"], checks["elastic"]
    assert p["bitwise_equal_back_to_back"], p
    assert p["max_rel_err_cpu"] <= PIPE_CPU_RTOL, p
    assert e["placements_as_asked"] and e["values_bitwise"], e
    assert e["loss_bitwise"] and e["state_bitwise"], e
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "sharded_sweep", "seconds": rec["seconds"],
          "runs_during_tune_wait_s": runs["seconds"],
          "checks_beside_tune_s": checks["seconds"],
          "nvidia_smi": rec["nvidia_smi"]})
    return rec


# ---------------------------------------------------------------------------
# phase 22: the models' shard(...) calls, the dry run, a sharded step
# ---------------------------------------------------------------------------

#: (a): the reference test's seven (arch, shape) pairs (tests/test_dryrun.py)
#: at full size, each on both production meshes, and the perf driver on one
DRY_PAIRS = [("qwen2.5-32b", "train_4k"), ("gemma2-27b", "prefill_32k"),
             ("mixtral-8x22b", "decode_32k"),
             ("falcon-mamba-7b", "long_500k"), ("whisper-base", "decode_32k"),
             ("internvl2-26b", "train_4k"),
             ("recurrentgemma-9b", "decode_32k")]
DRY_PERF = ("falcon-mamba-7b", "long_500k", "ssm.d_state=8")
#: (b): phi3-medium-14b at full width and depth in bf16, 2 prompts of
#: 2048 random tokens (seed 0) and 8 eager decode steps; one train step at
#: depth 2 (a functional step holds ~32 B a parameter), 4 x 1024 tokens
SHARD_ARCH = "phi3-medium-14b"
SHARD_BATCH, SHARD_PROMPT, SHARD_NEW = 2, 2048, 8
SHARD_TRAIN_LAYERS, SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ = 2, 4, 1024
#: the model modules whose ``shard`` calls (b) counts
SHARD_MODULES = ("layers", "transformer", "attention", "moe", "ssm",
                 "rglru", "encdec", "vlm")


def dryrun_cells(multi: bool, out: str, perf: bool) -> dict:
    """Phase 22 (a), a host child with no card: ``python -m
    repro_torch.launch.dryrun``'s ``main`` on each of ``DRY_PAIRS`` on one
    production mesh (a fake world of 256 or 512 ranks), each cell's
    argument bytes against the sharding rules' reckoning of every leaf's
    shard, and (``perf``) the perf driver's ``main`` on ``DRY_PERF``
    against that baseline."""
    import contextlib
    import io
    import math
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import logical_sharding, set_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch import perf as perf_mod
    from repro_torch.launch.mesh import make_production_mesh
    mesh_name = "pod2x16x16" if multi else "pod16x16"
    t0 = time.perf_counter()
    for arch, shape in DRY_PAIRS:
        dryrun.main(["--arch", arch, "--shape", shape, "--mesh",
                     "multipod" if multi else "pod", "--out", out])
    rec = {"mesh": mesh_name, "seconds": time.perf_counter() - t0,
           "cells": {}}
    mesh = make_production_mesh(multi_pod=multi)
    for arch, shape in DRY_PAIRS:
        with open(os.path.join(out, mesh_name, f"{arch}__{shape}.json")) as f:
            cell = json.load(f)
        with set_mesh(None):
            _, args, dims, _ = dryrun.abstract_cell(
                dryrun._dryrun_config(get_config(arch)), shape)
        reckoned = 0
        for t, d in zip(dryrun._tensors(args), _flat_dims(args, dims)):
            d = tuple(d) if d is not None else (None,) * t.dim()
            sh = logical_sharding(d, tuple(t.shape), mesh)
            reckoned += math.prod(sh.shard_shape(t.shape)) * t.element_size()
        mem = cell["memory"]
        rec["cells"][f"{arch}/{shape}"] = {
            "flops_total": cell["flops_total"],
            "collective_bytes_total": cell["collective_bytes_total"],
            "collectives": cell["collectives"],
            "temp_gib": mem["temp_size_in_bytes"] / 2**30,
            "argument_bytes": mem["argument_size_in_bytes"],
            "reckoned_argument_bytes": reckoned,
            "fits_h100": cell["fits_h100"], "trace_s": cell["trace_s"]}
    if perf:
        arch, shape, override = DRY_PERF
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            p = perf_mod.main(["--arch", arch, "--shape", shape, "--tag",
                               "override", "--set", override, "--dryrun-dir",
                               out, "--out", os.path.join(out, "perf")])
        rec["perf"] = {"cell": f"{arch}/{shape}", "set": override,
                       "table": buf.getvalue().strip().splitlines(),
                       "record": p["path"],
                       "written": os.path.exists(p["path"]),
                       "seconds": time.perf_counter() - t1}
        t1 = time.perf_counter()
        rec["phi3_counts"] = phi3_counts()
        rec["phi3_counts"]["seconds"] = time.perf_counter() - t1
    return rec


def phi3_counts() -> dict:
    """The dry run's counters over (b)'s two calls, traced on fake
    tensors in a fake world of one on ``make_host_mesh()``'s axes (the
    card's layout: every shard whole): the prefill at full depth and the
    depth-``SHARD_TRAIN_LAYERS`` train step, each as the perf model's
    terms (``launch/perf.py::_terms``)."""
    import dataclasses
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.launch import dryrun, perf
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import abstract_params, param_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import step as S
    dryrun._fake_world(1)
    mesh = make_host_mesh()
    cfg = dataclasses.replace(get_config(SHARD_ARCH), use_pallas=False)
    tcfg = dataclasses.replace(cfg, n_layers=SHARD_TRAIN_LAYERS,
                               remat="full")
    sc = S.StepConfig(opt=AdamWConfig(use_master=True))
    out = {}

    def count(name, fn, *args):
        counter = dryrun._LocalCounter()
        with set_mesh(mesh), counter:
            fn(*args)
        coll = dryrun.collective_stats(counter.events)
        rec = {"flops_total": counter.flops,
               "bytes_accessed_total": counter.bytes_accessed,
               "collective_bytes_total": coll["total_bytes"],
               "memory": {"temp_size_in_bytes": 0}}
        terms = perf._terms(rec)
        out[name] = {"flops": counter.flops,
                     "bytes_accessed": counter.bytes_accessed,
                     "collective_bytes": coll["total_bytes"],
                     "compute_s": terms["compute_s"],
                     "memory_s": terms["memory_s"]}

    with FakeTensorMode(allow_non_fake_inputs=True):
        defs = T.param_defs(cfg)
        with set_mesh(None):
            params = dryrun._sharded_abstract(
                abstract_params(defs, torch.bfloat16), param_specs(defs),
                mesh)
        toks = torch.zeros((SHARD_BATCH, SHARD_PROMPT), dtype=torch.int32)
        with torch.no_grad():
            count("prefill", T.prefill, params, cfg, toks,
                  SHARD_PROMPT + SHARD_NEW)
        del params
        tdefs = T.param_defs(tcfg)
        with set_mesh(None), \
                torch._subclasses.fake_tensor.unset_fake_temporarily():
            state = S.init_train_state(
                tcfg, abstract_params(tdefs, torch.bfloat16), sc)
        specs = S.train_state_specs(tcfg, param_specs(tdefs), sc)
        with set_mesh(None):
            state = dryrun._sharded_abstract(state, specs, mesh)
        toks = torch.zeros((SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ),
                           dtype=torch.int32)
        count("train", S.make_train_step(tcfg, sc), state,
              {"tokens": toks, "labels": toks})
    return out


def _flat_dims(tree, spec) -> list:
    """The dims leaf of ``spec`` at each tensor of ``tree``, in
    ``dryrun._tensors`` order."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [spec]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [d for k in tree for d in _flat_dims(tree[k], spec[k])]
    return [d for t, sp in zip(tree, spec) for d in _flat_dims(t, sp)]


def dryrun_children(out: str) -> list:
    """Phase 22 (a)'s two host children (one a mesh), started after the
    build: they trace on the host while the card runs phases 3-21."""
    return [_child("dryrun_cells", False, out, True, card=False),
            _child("dryrun_cells", True, out, False, card=False)]


def _dtensors(tree, shardings, mesh):
    """``tree``'s tensors as DTensors on ``shardings``' placements over the
    same storage (a world of one: every shard is the whole tensor)."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.Tensor):
        return DTensor.from_local(tree, mesh, shardings.placements,
                                  run_check=False)
    if isinstance(tree, dict):
        return {k: _dtensors(v, shardings[k], mesh) for k, v in tree.items()}
    if tree is None:
        return None
    out = [_dtensors(t, s, mesh) for t, s in zip(tree, shardings)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def _whole(x):
    """A DTensor's whole value as a plain tensor (a plain one as is)."""
    from torch.distributed.tensor import DTensor
    while isinstance(x, DTensor):
        x = x.full_tensor()
    return x


class _ShardCalls:
    """Counts the models' ``shard`` calls while open."""

    def __enter__(self):
        import importlib
        from repro_torch.dist import sharding
        self.n = 0
        self.saved = []

        def counted(x, *dims):
            self.n += 1
            return sharding.shard(x, *dims)
        for name in SHARD_MODULES:
            m = importlib.import_module(f"repro_torch.models.{name}")
            if hasattr(m, "shard"):
                self.saved.append((m, m.shard))
                m.shard = counted
        return self

    def __exit__(self, *exc):
        for m, f in self.saved:
            m.shard = f


def _phi3_serve(params, cfg, toks, mesh, device) -> tuple:
    """Prefill and ``SHARD_NEW`` eager greedy decode steps, inside
    ``set_mesh(mesh)`` or (mesh None) outside any mesh, each under
    torch.profiler: (logits of every call, the record)."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.models import transformer as T
    ctx = set_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    outs, rec = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ctx, torch.no_grad(), _ShardCalls() as calls:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lg, caches = T.prefill(params, cfg, toks,
                                   SHARD_PROMPT + SHARD_NEW)
            lg = _whole(lg)
            torch.cuda.synchronize()
            rec["prefill_wall_ms"] = (time.perf_counter() - t0) * 1e3
        rec["prefill_device_ms"] = sum(_device_us(prof)[0].values()) / 1e3
        rec["prefill_shard_calls"] = calls.n
        outs.append(lg)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(SHARD_NEW):
                cur = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
                pos = torch.full((), SHARD_PROMPT + i, dtype=torch.int32,
                                 device=device)
                lg, caches = T.decode_step(params, cfg, cur, caches, pos)
                lg = _whole(lg)
                outs.append(lg)
            torch.cuda.synchronize()
            rec["decode_wall_ms_per_step"] = (
                (time.perf_counter() - t0) * 1e3 / SHARD_NEW)
        rec["decode_device_ms_per_step"] = (
            sum(_device_us(prof)[0].values()) / 1e3 / SHARD_NEW)
        rec["shard_calls"] = calls.n
    del caches
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["tokens"] = [o[:, -1].argmax(-1).tolist() for o in outs]
    return outs, rec


def _roofline(model: dict, device_ms: float) -> dict:
    """The perf model's terms beside a measured device time (busy ms by
    torch.profiler; "not measured" where it saw no device event)."""
    rec = {**model, "device_ms": device_ms or "not measured",
           "bound_ms": max(model["compute_s"], model["memory_s"]) * 1e3}
    if device_ms:
        rec["share_of_bf16_peak"] = (model["flops"] / (device_ms / 1e3)
                                     / BF16_PEAK_FLOPS)
    return rec


def _phi3_step(step, state, batch, mesh) -> tuple:
    """One train step inside ``set_mesh(mesh)`` or outside any mesh under
    torch.profiler: (loss, the new params, the record)."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.dist.sharding import set_mesh
    from repro_torch.optim._tree import leaves
    ctx = set_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ctx, profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new, m = step(state, batch)
        loss = _whole(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    params = [_whole(p) for p in leaves(new.params)]
    del new, m
    return loss, params, {"wall_ms": wall,
                          "device_ms": sum(_device_us(prof)[0].values()) / 1e3,
                          "peak_bytes": torch.cuda.max_memory_allocated()}


def _sharded_phi3(device) -> dict:
    """Phase 22 (b): phi3-medium-14b in a world of one over NCCL, under
    ``set_mesh(make_host_mesh())``, every parameter a DTensor placed by
    ``tree_shardings`` and the models' ``shard`` calls live, against the
    same calls outside any mesh (plain attention both ways, as the
    reference's dry run sets ``use_pallas=False``)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import set_mesh, tree_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params, param_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim._tree import leaves
    from repro_torch.train import step as S
    from repro_torch.tune.optimizers import deterministic
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    rec = {}
    line = rec["timeline_s"] = {}

    def mark(what):
        line[what] = time.perf_counter() - t_start
    try:
        mesh = make_host_mesh()
        rec["mesh"] = str(mesh)
        rec["backend"] = dist.get_backend(mesh.get_group(0))
        cfg = dataclasses.replace(get_config(SHARD_ARCH), use_pallas=False)
        defs = T.param_defs(cfg)
        t0 = time.perf_counter()
        params = init_params(defs, 0, torch.bfloat16, device)
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        rec["params"] = T.n_params(params)
        rec["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in leaves(params))
        placed = _dtensors(params, tree_shardings(param_specs(defs), params,
                                                  mesh), mesh)
        rec["all_dtensors"] = all(isinstance(p, DTensor)
                                  for p in leaves(placed))
        mark("params")
        g = torch.Generator(device=device).manual_seed(0)
        toks = torch.randint(2, cfg.vocab, (SHARD_BATCH, SHARD_PROMPT),
                             generator=g, device=device, dtype=torch.int32)
        with deterministic(device), torch.no_grad():   # warm-up, untimed
            T.prefill(params, cfg, toks[:, :256], 256)
        with deterministic(device):
            plain, rec["outside"] = _phi3_serve(params, cfg, toks, None,
                                                device)
            mark("serve_outside")
            reset_counts()
            sharded, rec["inside"] = _phi3_serve(placed, cfg, toks, mesh,
                                                 device)
            rec["launches"] = counts()
            rec["routes"] = routes()
            mark("serve_inside")
            rec["logits_bitwise"] = all(torch.equal(a, b)
                                        for a, b in zip(plain, sharded))
            rec["logits_max_abs_diff"] = max(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(plain, sharded))
            del plain, sharded
        emit({"phase": "sharded_models", "case": "sharded_phi3_serve",
              **{k: v for k, v in rec.items()}})
        del params, placed
        gc.collect()
        torch.cuda.empty_cache()

        # one train step at depth SHARD_TRAIN_LAYERS, each way
        tcfg = dataclasses.replace(cfg, n_layers=SHARD_TRAIN_LAYERS,
                                   remat="full")
        tdefs = T.param_defs(tcfg)
        sc = S.StepConfig(opt=AdamWConfig(use_master=True))
        state = S.init_train_state(
            tcfg, init_params(tdefs, 0, torch.bfloat16, device), sc)
        rec["train_params"] = T.n_params(state.params)
        toks = torch.randint(2, cfg.vocab,
                             (SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ),
                             generator=g, device=device, dtype=torch.int32)
        batch = {"tokens": toks, "labels": toks}
        step = S.make_train_step(tcfg, sc)
        specs = S.train_state_specs(tcfg, param_specs(tdefs), sc)
        shs = tree_shardings(specs._replace(rng=None),
                             state._replace(rng=None), mesh)
        dstate = _dtensors(state._replace(rng=None), shs, mesh)._replace(
            rng=state.rng)
        mark("train_state")
        with deterministic(device):
            loss0, p0, rec["train_outside"] = _phi3_step(step, state, batch,
                                                         None)
            mark("train_outside")
            reset_counts()
            loss1, p1, rec["train_inside"] = _phi3_step(step, dstate, batch,
                                                        mesh)
            rec["train_launches"] = counts()
            mark("train_inside")
            rec["train_loss"] = [float(loss0), float(loss1)]
            rec["train_loss_bitwise"] = torch.equal(loss0, loss1)
            rec["train_param_types"] = sorted(
                {type(a).__name__ + "/" + type(b).__name__
                 for a, b in zip(p0, p1)})
            rec["train_params_bitwise"] = all(
                torch.equal(_whole(a), _whole(b)) for a, b in zip(p0, p1))
            del p0, p1
        rec["train_tokens"] = SHARD_TRAIN_BATCH * SHARD_TRAIN_SEQ
        del state, dstate
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    mark("end")
    for way in ("outside", "inside"):
        r = rec[way]
        r["decode_tok_per_s"] = SHARD_BATCH / (
            r["decode_wall_ms_per_step"] / 1e3)
    rec["dispatch_cost_ms"] = {
        "prefill": rec["inside"]["prefill_wall_ms"]
        - rec["outside"]["prefill_wall_ms"],
        "decode_step": rec["inside"]["decode_wall_ms_per_step"]
        - rec["outside"]["decode_wall_ms_per_step"],
        "train_step": rec["train_inside"]["wall_ms"]
        - rec["train_outside"]["wall_ms"]}
    return rec


def phase_sharded_models(device, dry: list) -> dict:
    """Phase 22: (b) the sharded phi3-medium-14b step on the card, then
    (a) the dry run's host children (``dry``, started after the build)
    joined and gated."""
    t_phase = time.perf_counter()
    rec = {"phase": "sharded_models", "nvidia_smi": nvidia_smi()}
    b = rec["sharded_phi3"] = _sharded_phi3(device)
    b["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "sharded_models", "case": "sharded_phi3",
          "nvidia_smi": rec["nvidia_smi"], **b})
    assert b["all_dtensors"] and b["backend"] == "nccl", b
    assert b["inside"]["shard_calls"] > 0 and \
        b["outside"]["shard_calls"] > 0, b
    assert b["logits_bitwise"], b["logits_max_abs_diff"]
    assert b["inside"]["tokens"] == b["outside"]["tokens"], b
    assert b["train_loss_bitwise"] and b["train_params_bitwise"], b
    assert not any(b["launches"].values()), b["launches"]
    assert not any(b["routes"].values()), b["routes"]
    assert not any(b["train_launches"].values()), b["train_launches"]
    t_join = time.perf_counter()
    cells = [_join(p, f"dryrun_cells {i}") for i, p in enumerate(dry)]
    rec["dryrun"] = {"join_wait_s": time.perf_counter() - t_join,
                     "meshes": cells}
    for c in cells:
        for name, cell in c["cells"].items():
            emit({"phase": "sharded_models", "case": "dryrun",
                  "mesh": c["mesh"], "cell": name, **cell})
            assert cell["argument_bytes"] == \
                cell["reckoned_argument_bytes"], (name, cell)
            assert cell["flops_total"] > 0, (name, cell)
        assert len(c["cells"]) == len(DRY_PAIRS), c
    perf = cells[0]["perf"]
    emit({"phase": "sharded_models", "case": "perf", **perf})
    assert perf["written"] and any("->" in ln for ln in perf["table"]), perf
    counted = cells[0]["phi3_counts"]
    b["prefill_model"] = _roofline(counted["prefill"],
                                   b["inside"]["prefill_device_ms"])
    b["train_model"] = _roofline(counted["train"],
                                 b["train_inside"]["device_ms"])
    emit({"phase": "sharded_models", "case": "sharded_phi3_model",
          "prefill": b["prefill_model"], "train": b["train_model"],
          "counted_s": counted["seconds"]})
    rec["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "sharded_models", "seconds": rec["seconds"],
          "dryrun_seconds": [c["seconds"] for c in cells],
          "nvidia_smi": rec["nvidia_smi"]})
    return rec


def _beside_tune(device, started: list, want: dict) -> dict:
    """What runs while the tune phase waits on its host-bound children:
    phase 20's checks (b)-(e) here, phase 21's (c) and (d) in a child;
    phase 21's (a) and (b) children start here (into ``started``, to
    digests ``want``) and do their host work."""
    t0 = time.perf_counter()
    started.extend(sharded_children(want))
    proc = _child("sharded_checks")
    try:
        train = train_checks(device)
        sharded = _join(proc, "sharded_checks")
    finally:
        _stop([proc])
    sharded["seconds"] = time.perf_counter() - t0
    return {"train": train, "sharded": sharded}


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
    # cuBLAS's deterministic workspace, for the train phase's deterministic
    # algorithms (and its launcher child), before the first product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
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
    import tempfile
    pacer_cpu = {}
    with tempfile.TemporaryDirectory() as dry_out:
        dry = dryrun_children(dry_out)      # phase 22 (a), on the host
        try:
            rows = _phases(device, pacer_cpu, dry)
        finally:
            _stop(list(pacer_cpu.values()) + dry)
    total = time.perf_counter() - t_start
    emit({"phase": "total", "seconds": total, "budget_s": BUDGET_S,
          "within_budget": total <= BUDGET_S,
          "phase_seconds": _phase_seconds()})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _counter(name: str) -> str:
    """The ``counts()`` key that a kernel row's launches fall under (the
    routes and plans of one wrapper share its count)."""
    return name.replace("_cuda_core", "").replace("_group", "")


def _group_row(row: dict, fam: dict) -> None:
    """The group kernel's kernels-line row: times at recurrentgemma's
    served decode shape (phase 15, graph replay), its errors there and
    in phase 13, launches on the serve_recurrentgemma path; the library
    is SDPA (the faster of SDPA and flex there, no softcap)."""
    rec = fam["attention"]["decode"]["recurrentgemma-9b"]
    assert rec["plan"]["kernel"] == "group", rec["plan"]
    row.update({"ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["sdpa_ms"],
                "max_abs_err": max(row["max_abs_err"], rec["max_abs_err"]),
                "launches": fam["models"]["recurrentgemma-9b"]["plans"][
                    "group"]})


def _paths_launches(rows: list, paths: dict) -> None:
    """Each kernel row's launches on each of ``paths`` (name -> that
    path's launch counts) where it ran there, as ``launches_by_path``."""
    for row in rows:
        by = {p: c[row["name"]] for p, c in paths.items()
              if c.get(row["name"])}
        if by:
            row.setdefault("launches_by_path", {}).update(by)


def _phases(device, pacer_cpu: dict, dry: list) -> list:
    """Phases 3-22; returns the kernels line's rows.  The pacer's CPU
    schedules (``pacer_cpu``, a process each) run beside the what-if and
    fleet phases, after the phases that time eager host work; phase 22's
    dry run (``dry``, two host processes) from the build on."""
    kern = phase_kernels(device)
    seg = phase_segment_reduce(device)
    phase_paper(device)
    phase_golden(device)
    dc = phase_dc(device)
    dc_digests = _digests(dc["result"])     # phase 21's reference
    for name, row in kern.items():
        row["launches"] = dc["launches"][name]
    _, mstep, mblock = phase_mega(device, dc)
    hot = phase_hotspot(device)
    seg["launches"] = hot["segment_sum"]["launches"]["segment_reduce"]
    phase_capture(device)          # ends with the sweep cache cleared
    pacer_cpu.update({s: _child("pacer_cpu", s) for s in PACER_SCHEMES})
    whatif = phase_whatif(device, dc)
    fleet = phase_fleet(device, dc)
    pacer = phase_pacer(device, pacer_cpu)
    del dc["result"], dc["check_result"]
    paths = {"whatif_serve_mix": whatif["serve_mix"]["launches"],
             "whatif_dc_flow": whatif["dc_flow"]["launches"],
             "whatif_dc_mega": whatif["dc_mega"]["launches"],
             "whatif_dc_auto_drain": whatif["dc_auto_drain"]["launches"],
             "whatif_dc_via_fleet": whatif["dc_via_fleet"]["launches"],
             "fleet_dc": fleet["launches"],
             **{f"pacer_{k}": v["launches"]
                for k, v in pacer["schemes"].items()}}
    _paths_launches(list(kern.values()) + [seg, mblock], paths)
    attn = phase_attention(device)
    serve = phase_serve(device, attn["decode_attention"]["ms"] * 1e3)
    attn["flash_attention"]["launches"] = serve["routes"]["tensor_core"]
    attn["decode_attention"]["launches"] = serve["plans"]["split"]
    f32 = phase_serve_f32(device)
    attn["flash_attention_cuda_core"]["launches"] = \
        f32["routes"]["kernels"]["cuda_core"]
    fam = phase_serve_families(device)     # after gemma2's 67 GB are freed
    _group_row(attn["decode_attention_group"], fam)
    attn_rows = [attn[n] for n in ATTN]
    for arch, m in fam["models"].items():
        _paths_launches(attn_rows, {f"serve_{arch}": {
            "flash_attention": m["routes"]["tensor_core"],
            "flash_attention_cuda_core": m["routes"]["cuda_core"],
            "decode_attention": m["plans"]["split"],
            "decode_attention_group": m["plans"]["group"]}})
    mm = phase_serve_encdec_vlm(device)    # after the families are freed
    paths = {f"serve_{arch}": {
        "flash_attention": m["served_routes"]["tensor_core"],
        "flash_attention_cuda_core": m["served_routes"]["cuda_core"],
        "decode_attention": m["served_plans"]["split"],
        "decode_attention_group": m["served_plans"]["group"]}
        for arch, m in mm["models"].items()}
    f32 = mm["whisper_f32"]
    paths["serve_whisper-base_f32"] = {
        "flash_attention_cuda_core": f32["routes"]["kernels"]["cuda_core"],
        "decode_attention": f32["launches"]["kernels"]["decode_attention"]}
    _paths_launches(attn_rows, paths)
    phase_card_vs_cpu(device)
    children = []      # phase 21's (a) and (b), started beside the tune
    try:
        tune = phase_tune(
            device, beside=lambda: _beside_tune(device, children, dc_digests),
            last=lambda: sharded_runs(children))
    finally:
        _stop(children)
    for name in ("gen_np_step", "rp_step", "segment_reduce"):
        row = seg if name == "segment_reduce" else kern[name]
        row["tune_launches"] = \
            tune["value_and_grad"]["launches_forward"][name]
    rows = list(kern.values()) + [seg, mstep, mblock, *attn_rows]
    train = phase_train(device, tune["beside"]["train"])
    sharded = phase_sharded_sweep(tune["beside"]["sharded"], tune["last"])
    launched = train["full_width"]["launches"]
    for row in rows:       # the training path launches none of them
        row["train_launches"] = launched[_counter(row["name"])]
    paths = {f"sharded_dc_world_of_one_{t}":
             sharded["world_of_one"][t]["launches"] for t in ("flow", "mega")}
    paths["sharded_dc_world_of_one_nccl_mega"] = \
        sharded["world_of_one"]["nccl_mega"]["launches"]
    for r in sharded["two_ranks"]:
        for t in ("flow", "mega"):
            paths[f"sharded_dc_rank{r['rank']}_{t}"] = r[t]["launches"]
    _paths_launches(rows, paths)
    models = phase_sharded_models(device, dry)["sharded_phi3"]
    for row in rows:       # the sharded model paths launch none of them
        name = _counter(row["name"])
        row.setdefault("launches_by_path", {}).update({
            "sharded_phi3_serve": models["launches"][name],
            "sharded_phi3_train": models["train_launches"][name]})
    return rows


if __name__ == "__main__":
    sys.exit(main())
