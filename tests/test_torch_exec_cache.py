"""The port's executable cache (``repro_torch.core.exec_cache``) and the
Sweep's cached trace windows (``SWEEP_EXEC_CACHE``), on the CPU.

  * ``ExecutableCache`` against the reference's on the same sequences of
    ``get_or_build`` / ``resize`` / ``reset_stats`` / ``clear`` (the
    reference's cases, ``tests/test_whatif_engine.py``): equal values,
    ``CacheStats`` and ``to_dict``; the port's one addition, releasing
    evicted and cleared entries;
  * ``structural_signature``: equal for equal structure, different for
    another shape, dtype, static value or schedule length;
  * ``Sweep.run`` through the cache: a second run of one structure is a
    hit; sweep A (a miss), then B of the same structure with other CC
    parameters (a hit), then A again are each bitwise equal to a run on a
    cleared cache (no stale data in a rebound entry); and bitwise equal
    to the eager ``decimating_scan`` over ``Sweep.prepare``.

On the CPU an entry runs its window eagerly over the tensors it owns, so
these tests cover the cache's logic; the ``cuda``-marked cases hold the
captured CUDA graphs against the eager calls on a card.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

from repro.core import exec_cache as EC_R                   # noqa: E402
from repro_torch.core import (CCScheme, PAPER_CONFIG,       # noqa: E402
                              SWEEP_EXEC_CACHE, ScenarioSpec, Sweep,
                              config_grid)
from repro_torch.core import exec_cache as EC_P             # noqa: E402
from repro_torch.core.experiments import WindowStatic       # noqa: E402
from repro_torch.core.simulator import decimating_scan      # noqa: E402
from repro_torch.kernels.fluid_reduce import ReduceSchedule  # noqa: E402

N_STEPS, TRACE = 60, 10


# ---------------------------------------------------------------------------
# the cache against the reference's
# ---------------------------------------------------------------------------

#: the reference's cases (tests/test_whatif_engine.py:252-283), as
#: (capacity, ops): ("get", key, value), ("resize", n), ("reset",),
#: ("clear",)
CACHE_CASES = {
    "counts_and_lru": (2, [("get", "a", 1), ("get", "a", 99),
                           ("get", "b", 2), ("get", "c", 3),
                           ("get", "a", 4)]),
    "resize_and_stats_delta": (4, [("get", "a", "a"), ("get", "b", "b"),
                                   ("get", "c", "c"), ("get", "d", "d"),
                                   ("resize", 2), ("get", "d", "x")]),
    "reset_and_clear": (3, [("get", "a", 1), ("get", "b", 2),
                            ("get", "a", 7), ("reset",), ("get", "c", 3),
                            ("get", "d", 4), ("clear",), ("get", "a", 5),
                            ("resize", 1), ("get", "b", 6)]),
}


def _drive(mod, capacity, ops):
    """Run ``ops`` on a fresh cache of ``mod``; the trace of everything
    the cache reports after each op."""
    c = mod.ExecutableCache(capacity=capacity, name="t")
    built, trace = [], []
    for op in ops:
        if op[0] == "get":
            _, key, val = op
            got = c.get_or_build(key, lambda v=val: built.append(v) or v)
            trace.append(("value", got))
        elif op[0] == "resize":
            c.resize(op[1])
        elif op[0] == "reset":
            c.reset_stats()
        else:
            c.clear()
        s = c.stats()
        trace.append((s.hits, s.misses, s.evictions, s.lookups,
                      s.hit_rate, s.to_dict(), len(c), c.keys(),
                      c.capacity))
    return trace, built


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_matches_reference(case):
    capacity, ops = CACHE_CASES[case]
    assert _drive(EC_P, capacity, ops) == _drive(EC_R, capacity, ops)
    for mod in (EC_P, EC_R):
        with pytest.raises(ValueError):
            mod.ExecutableCache(capacity=0)
        a, b = mod.CacheStats(3, 2, 1, 0.5), mod.CacheStats(1, 1, 0, 0.25)
        assert dataclasses.astuple(a - b) == (2, 1, 1, 0.25)


def test_cache_releases_evicted_and_cleared_entries():
    class Entry:
        def __init__(self, tag):
            self.tag, self.released = tag, False

        def release(self):
            self.released = True

    c = EC_P.ExecutableCache(capacity=2)
    e = {k: c.get_or_build(k, lambda k=k: Entry(k)) for k in "abc"}
    assert e["a"].released and not e["b"].released        # evicted
    c.resize(1)
    assert e["b"].released and not e["c"].released        # shrunk
    c.clear()
    assert e["c"].released and len(c) == 0
    assert c.stats().evictions == 2                       # clear: none
    c.get_or_build("plain", lambda: 1)                    # no release()
    c.clear()


# ---------------------------------------------------------------------------
# structural_signature
# ---------------------------------------------------------------------------

def _tree(n=5, dtype=torch.float32, items=3, n_long=1):
    return {"x": torch.zeros((2, n), dtype=dtype),
            "sched": ReduceSchedule(torch.zeros((items, 4), dtype=torch.int32),
                                    torch.zeros(n, dtype=torch.uint8), n_long),
            "none": None}


def test_structural_signature():
    sig = EC_P.structural_signature
    base = sig((10, "fused"), _tree())
    assert base == sig((10, "fused"), _tree())
    hash(base)
    for other in (sig((10, "fused"), _tree(n=6)),
                  sig((10, "fused"), _tree(dtype=torch.float64)),
                  sig((20, "fused"), _tree()),
                  sig((10, "pallas"), _tree()),
                  sig((10, "fused"), _tree(items=4)),
                  sig((10, "fused"), _tree(n_long=2))):
        assert other != base


def _paper(t_start=0.0, **grid):
    """Two schemes on the paper's incast, flows open at ``t_start``; with
    ``grid``: the configs of ``config_grid`` over DCQCN."""
    spec = ScenarioSpec.paper_incast(roll=0, t_start=t_start)
    cfgs = {s.name: PAPER_CONFIG.replace(scheme=s)
            for s in (CCScheme.DCQCN, CCScheme.DCQCN_REV)}
    if grid:
        cfgs = {k: c for k, c in config_grid(
            PAPER_CONFIG.replace(scheme=CCScheme.DCQCN), **grid).items()}
    return Sweep.grid(configs=cfgs, scenarios={"hol": spec})


def test_sweep_signature_ignores_data_and_depth():
    kw = dict(reduce="fused", use_kernels=False, pad_runs_to=None,
              min_delay_slots=None, dense_rows=None, temperature=0.0,
              min_switches=None, mesh=None, device="cpu")
    sig = EC_P.structural_signature
    a = _paper(**{"dcqcn.kmin": [8192.0, 15360.0]})
    b = _paper(**{"dcqcn.kmin": [4096.0, 12000.0]})
    sa, ia, _ = a._prepare(N_STEPS, TRACE, **kw)
    sb, ib, _ = b._prepare(2 * N_STEPS, TRACE, **kw)
    assert isinstance(sa, WindowStatic)
    assert sig(sa, ia) == sig(sb, ib)            # data and depth: no part
    st, it, _ = _paper(t_start=1e-3)._prepare(N_STEPS, TRACE, **kw)
    assert sig(st, it) == sig(sa, ia)
    sm, im, _ = a._prepare(N_STEPS, TRACE, **{**kw, "use_kernels": "mega"})
    so, io, _ = a._prepare(N_STEPS, 2 * TRACE, **kw)
    sv, iv, _ = _paper(**{"dcqcn.kmin": [1e3, 2e3, 3e3]})._prepare(
        N_STEPS, TRACE, **kw)
    keys = {sig(sa, ia), sig(sm, im), sig(so, io), sig(sv, iv)}
    # a different tier, window depth, and point count: three more keys
    assert len(keys) == 4


# ---------------------------------------------------------------------------
# Sweep.run through the cache
# ---------------------------------------------------------------------------

def _leaves(res):
    for f in res.traces._fields:
        yield f"traces.{f}", np.asarray(getattr(res.traces, f))
    for f in res.final._fields:
        x = getattr(res.final, f)
        for k, v in (x.items() if isinstance(x, dict) else [("", x)]):
            yield f"final.{f}{k}", np.asarray(v)


def _bitwise(a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    return all(np.array_equal(x, y, equal_nan=True)
               for (_, x), (_, y) in zip(la, lb))


def _eager(sweep, device, **kw):
    """The same run issued eagerly: ``Sweep.prepare`` and the uncaptured
    ``decimating_scan``."""
    stg = sweep.prepare(N_STEPS, TRACE, device=device, **kw)
    final, tr = decimating_scan(stg.step, stg.state, stg.n_samples,
                                stg.trace_every,
                                float(sweep.points[0].cfg.sim.dt),
                                sweep.n_vcs, block_fn=stg.block)
    return sweep.collect(final, tr, stg.trace_every)


def _fresh(sweep, device, **kw):
    SWEEP_EXEC_CACHE.clear()
    return sweep.run(N_STEPS, TRACE, device=device, **kw)


ENGINES = [{}, {"use_kernels": "mega"}, {"reduce": "pallas"}]
ENGINE_IDS = ["flow", "mega", "pallas"]


@pytest.mark.parametrize("kw", ENGINES, ids=ENGINE_IDS)
def test_sweep_hits_rebinds_and_matches_eager(kw):
    a = _paper(**{"dcqcn.kmin": [8192.0, 15360.0],
                  "dcqcn.rate_decrease_factor": [0.5, 0.25]})
    b = _paper(**{"dcqcn.kmin": [2048.0, 4096.0],
                  "dcqcn.rate_decrease_factor": [0.4, 0.7]})
    want_a, want_b = _fresh(a, "cpu", **kw), _fresh(b, "cpu", **kw)
    assert not _bitwise(want_a, want_b)        # B's parameters matter
    assert _bitwise(want_a, _eager(a, "cpu", **kw))
    SWEEP_EXEC_CACHE.clear()
    s0 = SWEEP_EXEC_CACHE.stats()
    got = [s.run(N_STEPS, TRACE, device="cpu", **kw) for s in (a, b, a)]
    d = SWEEP_EXEC_CACHE.stats() - s0
    assert (d.misses, d.hits) == (1, 2)
    assert len(SWEEP_EXEC_CACHE) == 1
    for res, want in zip(got, (want_a, want_b, want_a)):
        assert _bitwise(res, want)


def test_sweep_entry_owns_its_inputs():
    """A hit copies the new batch into the entry's own tensors: never
    into a tensor of the caller's batch or of the upload cache."""
    from repro_torch.core.experiments import _sweep_executable
    kw = dict(reduce="fused", use_kernels=False, pad_runs_to=None,
              min_delay_slots=None, dense_rows=None, temperature=0.0,
              min_switches=None, mesh=None, device="cpu")
    SWEEP_EXEC_CACHE.clear()
    sa, ia, _ = _paper()._prepare(N_STEPS, TRACE, **kw)
    with _sweep_executable(sa, ia) as entry:
        pass
    sb, ib, _ = _paper(**{"dcqcn.kmin": [2048.0, 4096.0]})._prepare(
        N_STEPS, TRACE, **kw)
    before = ia.par.mark["cp_kmin"].clone()
    with _sweep_executable(sb, ib) as hit:
        assert hit is entry
        assert torch.equal(entry.inputs.par.mark["cp_kmin"],
                           ib.par.mark["cp_kmin"])
    assert torch.equal(ia.par.mark["cp_kmin"], before)
    mine = {id(t) for t in (ia.sd.alt_routes, ia.sd.red_perm, ib.sd.red_perm,
                            ia.state.nicq, ia.plan.seg_rows)}
    assert not mine & {id(entry.inputs.sd.alt_routes),
                       id(entry.inputs.sd.red_perm),
                       id(entry.inputs.state.nicq),
                       id(entry.inputs.plan.seg_rows)}
    assert entry.nbytes() > 0
    SWEEP_EXEC_CACHE.clear()
    assert entry.inputs is None                          # released


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU form)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", ENGINES, ids=ENGINE_IDS)
def test_captured_windows_match_eager_on_cuda(kw):
    """Captured trace windows bitwise equal to the eager calls, through a
    miss, a hit with other CC parameters and a rerun, with each CC
    kernel counted once a step (segment_reduce / megastep_block as
    launched)."""
    from repro_torch.kernels import cc_step
    dev = _cuda()
    a = _paper(**{"dcqcn.kmin": [8192.0, 15360.0]})
    b = _paper(**{"dcqcn.kmin": [2048.0, 4096.0]})
    want = {id(s): _eager(s, dev, **kw) for s in (a, b)}
    SWEEP_EXEC_CACHE.clear()
    for s in (a, b, a):
        cc_step.reset_launch_counts()
        got = s.run(N_STEPS, TRACE, device=dev, **kw)
        assert _bitwise(got, want[id(s)])
        if kw.get("use_kernels") != "mega":
            assert cc_step.LAUNCHES["rp_step"] == N_STEPS
    assert SWEEP_EXEC_CACHE.stats().misses >= 1 and len(SWEEP_EXEC_CACHE) == 1
    SWEEP_EXEC_CACHE.clear()


def _greedy_eager(cfg, params, prompts, n_new, device):
    """Greedy tokens of equal-length ``prompts`` through
    ``transformer.prefill`` and an eager ``decode_step`` loop."""
    from repro_torch.models import transformer as T
    toks = torch.tensor(prompts, dtype=torch.int32, device=device)
    with torch.no_grad():
        logits, caches = T.prefill(params, cfg, toks, 64)
        out = [logits[:, -1].argmax(-1).to(torch.int32)]
        pos = torch.tensor(toks.shape[1], dtype=torch.int32, device=device)
        for _ in range(n_new - 1):
            logits, caches = T.decode_step(params, cfg, out[-1][:, None],
                                           caches, pos)
            pos = caches[0].pos
            out.append(logits[:, 0].argmax(-1).to(torch.int32))
    return torch.stack(out, 1).cpu().tolist()


@pytest.mark.cuda
def test_serve_engine_captures_once_on_cuda():
    """The engine's decode step captured once for the engine's life: its
    tokens equal an eager decode loop's, over two ``generate`` calls
    (the second rewrites the engine's caches in place), past gemma2's
    window of 16, with decode_attention counted once a layer a step."""
    from repro_torch.configs import get_smoke_config
    DA = importlib.import_module("repro_torch.kernels.decode_attention")
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    dev = _cuda()
    cfg = dataclasses.replace(get_smoke_config("gemma2-27b"),
                              use_pallas=True)
    params = init_params(T.param_defs(cfg), 0, device=dev)
    rng = np.random.RandomState(4)
    eng = ServingEngine(cfg, params, ServeConfig(batch_slots=3, max_len=64,
                                                 eos_token=-1), device=dev)
    for n_new in (20, 12):
        prompts = [[int(x) for x in rng.randint(2, cfg.vocab, 9)]
                   for _ in range(3)]
        DA.reset_launch_counts()
        got = eng.generate(prompts, max_new_tokens=n_new)
        assert DA.LAUNCHES["decode_attention"] == cfg.n_layers * (n_new - 1)
        assert got == _greedy_eager(cfg, params, prompts, n_new, dev)
    assert eng.captures == 1


def test_capture_counts_every_kernel_module():
    """The counters a captured graph keeps in step are every kernel
    module's ``LAUNCHES`` (and flash's ``ROUTES``, decode's ``PLANS``),
    the module dicts themselves."""
    from repro_torch.kernels import capture
    got = capture._counters()
    for name in ("cc_step", "fluid_reduce", "fluid_step", "flash_attention",
                 "decode_attention"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        assert any(c is mod.LAUNCHES for c in got), name
    assert any(c is importlib.import_module(
        "repro_torch.kernels.flash_attention").ROUTES for c in got)
    assert any(c is importlib.import_module(
        "repro_torch.kernels.decode_attention").PLANS for c in got)
