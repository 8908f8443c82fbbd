"""The trace of ``Sweep.run`` (``repro_torch.core.obs``), the byte
counters and the megakernel's phase timers.

On the CPU:
  * the spans of one run nest as ``obs`` documents them, in one record a
    run (a sweep id each, also for runs in two threads at once), with one
    ``window`` span a window;
  * with tracing off no record is kept, no ``record_function`` entered,
    and the result is bitwise the traced run's; under ``torch.profiler``
    each span but ``window`` is a profiler range of its name;
  * the content caches' counters: a cold cache hashes the scenarios and
    hashes and uploads the staged fields, a second sweep of the structure
    hits the stage cache on the staged structure's bytes and reuses the
    put cache's fields;
  * the timers' marks in ``csrc/fluid_step.cu``: one after every barrier
    of the step loop, named in ``kernels.fluid_step.PHASES`` by the
    barrier and the ``// ----`` comment above it;
  * the benchmark's readers of the record (``ccbench/metrics``) on
    hand-made records, and None where they do not apply.

On a card (``cuda``-marked, skipped elsewhere): megakernel results
bitwise equal with the timers on and off, a traced sweep timing its last
window only, the phases' cycles summing to the loop's, the untimed kernel
leaving the accumulators untouched, and ``h2d_bytes`` equal to the staged
tensors' bytes on a cold cache.
"""

import importlib.util
import os
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

from repro_torch.core import (CCScheme, PAPER_CONFIG,         # noqa: E402
                              ScenarioSpec, Sweep)
from repro_torch.core import experiments, fluid, obs          # noqa: E402
from repro_torch.core.experiments import _tensor_leaves       # noqa: E402
from repro_torch.kernels import fluid_step as FS              # noqa: E402

from _torch_sweeps import assert_bitwise                      # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS, TRACE = 60, 10
ROOT_CHILDREN = ["sweep.stage", "sweep.plan", "sweep.lookup",
                 "sweep.windows", "sweep.collect"]


def _sweep(n_senders: int = 3) -> Sweep:
    """A small grid whose structure (flow count) no other test of the
    file uses, so its first run misses the executable cache."""
    return Sweep.grid(
        configs={s.name: PAPER_CONFIG.replace(scheme=s) for s in CCScheme},
        scenarios={"i": ScenarioSpec.incast(n_senders, victim=False)})


def _traced(sweep, **kw) -> obs.Record:
    with obs.recording():
        res = sweep.run(N_STEPS, trace_every=TRACE, device="cpu", **kw)
    return obs.last(), res


def _nbytes(tree) -> int:
    return sum(obs.nbytes(t) for t in _tensor_leaves(tree, []))


def test_spans_nest_in_one_record_a_run():
    rec, _ = _traced(_sweep(7))
    spans = rec.spans
    assert spans[0].name == "sweep.run" and spans[0].parent == -1
    names = [s.name for s in spans]
    assert names.count("sweep.run") == 1
    assert [s.name for s in spans if s.parent == 0] == ROOT_CHILDREN
    lookup = names.index("sweep.lookup")
    assert [s.name for s in spans if s.parent == lookup] == ["sweep.capture"]
    windows = names.index("sweep.windows")
    assert {s.name for s in spans if s.parent == windows} == {"window"}
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # siblings in order, none overlapping
    kids = [s for s in spans if s.parent == 0]
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert (rec.runs, rec.tier, rec.device) == (3, "off", "cpu")
    # the structure is cached now: no capture span
    again, _ = _traced(_sweep(7))
    assert "sweep.capture" not in [s.name for s in again.spans]
    assert again.sweep_id > rec.sweep_id


def test_records_are_per_thread():
    sweeps = [_sweep(n) for n in (2, 6)]
    got, errors = [None, None], []

    def run(i):
        try:
            got[i] = sweeps[i].run(N_STEPS, trace_every=TRACE, device="cpu")
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    with obs.recording():
        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    recs = obs.records()[-2:]
    assert len({r.sweep_id for r in recs}) == 2
    for r in recs:
        assert [s.name for s in r.spans].count("sweep.run") == 1
        assert r.windows == N_STEPS // TRACE
    assert obs.current() is None


def test_one_window_span_a_window():
    for kw in ({}, {"use_kernels": "mega"}):
        rec, _ = _traced(_sweep(), **kw)
        n = N_STEPS // TRACE
        assert len(rec.named("window")) == n == rec.windows
        assert rec.window_ms == [] and rec.mega_loop_ns is None
        # on the CPU nothing crosses to a card
        assert rec.counters["h2d_bytes"] == rec.counters["d2h_bytes"] == 0


def test_tracing_off_keeps_nothing(monkeypatch):
    sweep = _sweep()
    traced, res_on = _traced(sweep)
    entered = []
    real = torch.profiler.record_function

    def spy(*a, **k):
        entered.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    before = obs.last()
    res_off = sweep.run(N_STEPS, trace_every=TRACE, device="cpu")
    assert obs.last() is before is traced and entered == []
    assert_bitwise(res_off, res_on)


def test_profiler_sees_the_spans():
    from torch.profiler import ProfilerActivity, profile
    sweep = _sweep()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sweep.run(N_STEPS, trace_every=TRACE, device="cpu")
    rec = obs.last()
    seen = [e.name for e in prof.events()]
    for name in ["sweep.run"] + ROOT_CHILDREN:
        assert seen.count(name) == 1, name
    # a window is a span of the record, not a profiler range
    assert seen.count("window") == 0
    assert len(rec.named("window")) == rec.windows == N_STEPS // TRACE


def test_put_cache_counters():
    sweep = _sweep(5)
    fluid._PUT_CACHE.clear()
    fluid._INC_CACHE.clear()
    experiments.STAGE_CACHE.clear()
    cold, res = _traced(sweep)
    stg = sweep.prepare(N_STEPS, trace_every=TRACE, device="cpu")
    sd = stg.sd
    put = sum(obs.nbytes(getattr(sd, f)) for f in fluid._PUT_FIELDS)
    # each run's int32 route stack, digested for the incidence cache by
    # the upload and again by the dense walk's row count
    incidence = 2 * sd.alt_routes.numel() * 4
    # every field of each point's scenario, as stored, for the stage
    # cache's key
    raw = sum(np.asarray(v).nbytes for p in sweep.points
              for v in p.scenario if v is not None)
    structure = _nbytes(stg.sd) + _nbytes(stg.plan)
    assert cold.counters["put_hit_bytes"] == 0
    assert cold.counters["stage_hit_bytes"] == 0
    assert cold.counters["digest_bytes"] == raw + put + incidence
    # a warm run finds the structure staged: it hashes its scenarios
    # alone and reuses the put cache's tensors without a lookup
    warm, res2 = _traced(sweep)
    assert warm.counters["put_hit_bytes"] == put
    assert warm.counters["stage_hit_bytes"] == structure
    assert warm.counters["digest_bytes"] == raw
    assert_bitwise(res2, res)


# ---------------------------------------------------------------------------
# the megakernel's marks
# ---------------------------------------------------------------------------

STEP_LOOP = "for (long long step = 0; step < a.n_substeps; ++step) {"
BARRIERS = ("__syncthreads();", "cluster_sync();", "run_sync(c);")
MARK = re.compile(r"phase_(mark|exit)<kTimed>\((\d+)\);")


def _marks(src: str) -> list[tuple[str, str]]:
    """The step loop's marks in slot order, ``(where, phase)`` as
    ``PHASES`` has them; raises where a barrier of the loop is not
    followed by the next mark, or the loop is not opened and closed by
    its own."""
    lines = [x.strip() for x in src.split("\n")]
    start = next(i for i, x in enumerate(lines) if x.startswith(STEP_LOOP))
    if lines[start - 1] != "phase_enter<kTimed>();":
        raise ValueError("no phase_enter before the step loop")
    out, phase, depth, where = [], None, 0, "step"
    for i in range(start, len(lines)):
        x = lines[i]
        depth += x.count("{") - x.count("}")
        if depth <= 0:
            m = MARK.fullmatch(lines[i + 1])
            if not (m and m.group(1) == "exit"
                    and int(m.group(2)) == len(out)):
                raise ValueError("no exit mark after the step loop")
            out.append(("exit", phase))
            # slot 0, after the first step, closes a step's tail
            out[0] = (out[0][0], phase)
            return out
        if x.startswith("// ----"):
            phase = x.strip("/- ").strip()
        if x in BARRIERS or i == start:
            m = MARK.fullmatch(lines[i + 1])
            if not (m and m.group(1) == "mark"
                    and int(m.group(2)) == len(out)):
                raise ValueError(f"line {i + 1}: a barrier of the step "
                                 f"loop without the next mark after it")
            out.append((where if i == start else x.split("(")[0], phase))
    raise ValueError("unclosed step loop")


def test_a_mark_follows_every_barrier_of_the_step_loop():
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "fluid_step.cu")) as f:
        src = f.read()
    marks = _marks(src)
    assert len(marks) >= 12
    assert marks == [tuple(p) for p in FS.PHASES]
    assert re.search(r"constexpr int kPhaseMarks = (\d+);",
                     src).group(1) == str(len(FS.PHASES))
    # the loop's marks are all there is: one call a slot but the exit's
    assert len(re.findall(r"phase_mark<kTimed>\(", src)) == len(marks) - 1
    # a barrier without its mark, and skipped slots, are refused
    with pytest.raises(ValueError, match="barrier"):
        _marks(src.replace("    phase_mark<kTimed>(5);\n", "", 1))
    with pytest.raises(ValueError, match="barrier"):
        _marks(src.replace("phase_mark<kTimed>(5);",
                           "phase_mark<kTimed>(6);", 1))
    with pytest.raises(ValueError, match="exit"):
        _marks(src.replace("phase_exit<kTimed>(15);", "", 1))


# ---------------------------------------------------------------------------
# the benchmark's readers of the record
# ---------------------------------------------------------------------------

def _reader(name):
    path = os.path.join(ROOT, "ccbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"obs_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _record(device="cuda:0", tier="mega") -> obs.Record:
    rec = obs.Record(runs=12, device="cpu", profiled=False)
    rec.device, rec.on_card, rec.tier = device, device != "cpu", tier
    rec.spans = [obs.Span("sweep.run", -1, 0),
                 obs.Span("sweep.stage", 0, 1_000_000),
                 obs.Span("sweep.plan", 0, 4_000_000),
                 obs.Span("sweep.lookup", 0, 6_000_000),
                 obs.Span("sweep.windows", 0, 7_000_000),
                 obs.Span("window", 4, 7_000_000),
                 obs.Span("window", 4, 8_000_000)]
    for s, end in zip(rec.spans, (10_000_000, 4_000_000, 6_000_000,
                                  6_500_000, 9_000_000, 7_010_000,
                                  8_030_000)):
        s.end_ns = end
    rec.counters = {"h2d_bytes": 3_500_000, "put_hit_bytes": 500_000,
                    "digest_bytes": 2_000_000, "d2h_bytes": 1_250_000}
    if tier == "mega" and device != "cpu":
        rec.window_ms = [2.0]
        rec.mega_loop_ns = 1_600_000
        rec.mega_phases = [{"cycles": c} for c in (10, 60, 30)]
    return rec


def test_readers_on_a_hand_made_record(monkeypatch):
    want = {"sweep_stage_ms": 3.0, "sweep_plan_ms": 2.0,
            "sweep_lookup_ms": 0.5, "sweep_h2d_mb": 3.5,
            "sweep_d2h_mb": 1.25, "window_host_us": 20.0,
            "sweep_digest_mb": 2.0, "sweep_put_hit_mb": 0.5,
            "megastep_loop_share": 80.0, "megastep_top_phase_share": 60.0}
    monkeypatch.setattr(obs, "last", lambda: _record())
    for name, value in want.items():
        assert _reader(name)({}) == pytest.approx(value), name
    # a CPU record: no bytes to a card, no megakernel
    monkeypatch.setattr(obs, "last", lambda: _record(device="cpu"))
    for name in want:
        got = _reader(name)({})
        assert (got is None) == (name in ("sweep_h2d_mb", "sweep_d2h_mb",
                                          "megastep_loop_share",
                                          "megastep_top_phase_share")), name
    # the flow tier on the card: no megakernel
    monkeypatch.setattr(obs, "last", lambda: _record(tier="off"))
    assert _reader("megastep_loop_share")({}) is None
    assert _reader("megastep_top_phase_share")({}) is None
    assert _reader("sweep_h2d_mb")({}) == pytest.approx(3.5)
    # no record at all
    monkeypatch.setattr(obs, "last", lambda: None)
    for name in want:
        assert _reader(name)({}) is None, name


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_phase_timers_on_cuda():
    """Timers on and off give bitwise equal megakernel results; a traced
    sweep times its last window only, and does not capture the cached
    window anew; the phases' cycles sum to the loop's; the untimed
    kernel leaves the accumulators untouched."""
    from repro_torch.core import SWEEP_EXEC_CACHE
    dev = _card()
    sweep = _sweep()
    kw = dict(trace_every=TRACE, device=dev, use_kernels="mega")
    off = sweep.run(N_STEPS, **kw)
    stats = SWEEP_EXEC_CACHE.stats()
    with obs.recording():
        on = sweep.run(N_STEPS, **kw)
        rec = obs.last()
        on2 = sweep.run(N_STEPS, **kw)      # the timed graph is reused
    assert (SWEEP_EXEC_CACHE.stats() - stats).misses == 0
    assert_bitwise(on, off)
    assert_bitwise(on2, off)
    assert len(rec.window_ms) == 1
    assert 0 < rec.mega_loop_ns <= rec.window_ms[0] * 1e6
    # one window: TRACE steps, one loop exit
    assert [rec.mega_phases[i]["n"] for i in (0, -1)] == [TRACE, 1]
    assert obs.last().mega_loop_ns > 0
    stg = sweep.prepare(N_STEPS, **kw)
    with FS.phase_timers() as t:
        a = stg.block(stg.state)
    assert t["loops"] == 1 and t["phases"][0]["n"] == TRACE
    assert abs(sum(p["cycles"] for p in t["phases"]) - t["loop_cycles"]) \
        <= 0.02 * t["loop_cycles"]
    # untimed: the kernel leaves the accumulators as they were
    b = stg.block(stg.state)
    assert FS.read_phase_timers() == t
    for u, v in zip(a[1], b[1]):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_h2d_bytes_are_the_staged_tensors_on_cuda():
    dev = _card()
    sweep = _sweep(4)
    stg = sweep.prepare(N_STEPS, trace_every=TRACE, device=dev)
    staged = sum(_nbytes(x) for x in (stg.state, stg.sd, stg.par, stg.plan))
    fluid._PUT_CACHE.clear()
    experiments.STAGE_CACHE.clear()
    with obs.recording():
        sweep.run(N_STEPS, trace_every=TRACE, device=dev)
    rec = obs.last()
    assert rec.counters["h2d_bytes"] == staged
    assert rec.counters["d2h_bytes"] > 0
    # the flow tier: no megakernel, no timed window
    assert rec.windows == N_STEPS // TRACE and rec.window_ms == []
