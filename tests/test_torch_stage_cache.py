"""The stage cache of the port's Sweep (``experiments.STAGE_CACHE``), on
the CPU.

A sweep stages what depends on its scenarios alone (the batched
``ScenarioDev``, the ``ReducePlan``, the megakernel's tables) once, and
the sweeps of a parameter grid over the same scenarios find it there:

  * a sweep at one parameter point, then the same scenarios at another:
    the second ``_prepare`` is a hit (``stage_hit_bytes`` > 0), stages
    what a cleared cache stages, and its ``SweepResult`` is bitwise the
    same sweep's on a cleared cache; on the flow and the mega tier, with
    and without ``pad_runs_to`` (and on a card, ``cuda``-marked);
  * the key is content: a ``Scenario`` edited in place misses and gives
    a cleared-cache run's result; another ``min_switches``,
    ``dense_rows``, ``trace_every`` or mesh part misses;
  * two threads run sweeps of one structure at two parameter points:
    each gets its serial bits.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

from repro_torch.core import (CCScheme, PAPER_CONFIG,         # noqa: E402
                              ScenarioSpec, Sweep)
from repro_torch.core import experiments, obs                 # noqa: E402
from repro_torch.core.experiments import (STAGE_CACHE,        # noqa: E402
                                          _replace_path, _tensor_leaves)

from _torch_sweeps import assert_bitwise                      # noqa: E402

N_STEPS, TRACE = 60, 10
KW = dict(reduce="fused", use_kernels=False, pad_runs_to=None,
          min_delay_slots=None, dense_rows=None, temperature=0.0,
          min_switches=None, mesh=None, device="cpu")


def _base() -> Sweep:
    """The paper's three schemes on its incast (flows open at 0): three
    built scenarios the parameter points share."""
    return Sweep.grid(
        configs={s.name: PAPER_CONFIG.replace(scheme=s) for s in CCScheme},
        scenarios={"hol": ScenarioSpec.paper_incast(roll=0, t_start=0.0)})


def _at(base: Sweep, scale: float) -> Sweep:
    """``base``'s scenarios with DCQCN's marking thresholds x ``scale``."""
    pts = []
    for p in base.points:
        k = p.cfg.dcqcn.kmin * scale
        cfg = _replace_path(p.cfg, "dcqcn", dataclasses.replace(
            p.cfg.dcqcn, kmin=k, kmax=k))
        pts.append((p.name, cfg, p.scenario))
    return Sweep(pts)


def _hits(fn):
    """(the ``stage_hit_bytes`` that ``fn()`` added, its result)."""
    before = obs.totals()["stage_hit_bytes"]
    out = fn()
    return obs.totals()["stage_hit_bytes"] - before, out


def _run(sweep, **kw):
    return sweep.run(N_STEPS, TRACE, **dict(dict(device="cpu"), **kw))


def _prepare(sweep, **kw):
    return sweep._prepare(N_STEPS, TRACE, **dict(KW, **kw))


def _equal_inputs(a, b) -> None:
    """Two ``_prepare`` results stage the same bits."""
    (sa, ia, na), (sb, ib, nb) = a, b
    assert sa == sb and na == nb
    la, lb = _tensor_leaves(ia, []), _tensor_leaves(ib, [])
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if ia.mplan is not None:
        assert ia.mplan.geometry == ib.mplan.geometry


def _differ(a, b) -> bool:
    return not np.array_equal(a.traces.delivered, b.traces.delivered)


# ---------------------------------------------------------------------------
# a second parameter point hits
# ---------------------------------------------------------------------------

def _second_point_hits(device, tier, pad):
    kw = dict(use_kernels="mega" if tier == "mega" else False,
              pad_runs_to=pad, device=device)
    base = _base()
    STAGE_CACHE.clear()
    cold_hit, first = _hits(lambda: _run(_at(base, 0.5), **kw))
    hit, second = _hits(lambda: _run(_at(base, 2.0), **kw))
    assert cold_hit == 0 and hit > 0
    staged_hit = _prepare(_at(base, 2.0), **kw)
    STAGE_CACHE.clear()
    staged_cold = _prepare(_at(base, 2.0), **kw)
    _equal_inputs(staged_hit, staged_cold)
    # the bytes reused are the structure's: its scenario, plan and tables
    inp = staged_cold[1]
    mplan = inp.mplan
    tables = [] if mplan is None else [mplan.path_q, mplan.path_n,
                                       mplan.path_pos, mplan.red_rows,
                                       mplan.pool_rows]
    assert hit == sum(obs.nbytes(x) for x in _tensor_leaves(inp.sd, [])
                      + _tensor_leaves(inp.plan, []) + tables)
    STAGE_CACHE.clear()
    assert_bitwise(second, _run(_at(base, 2.0), **kw))
    assert _differ(first, second)        # the points' configs both count


@pytest.mark.parametrize("pad", [None, 5])
@pytest.mark.parametrize("tier", ["off", "mega"])
def test_a_second_parameter_point_hits(tier, pad):
    _second_point_hits("cpu", tier, pad)


@pytest.mark.cuda
def test_a_second_parameter_point_hits_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    dev = torch.device("cuda", torch.cuda.current_device())
    for tier in ("off", "mega"):
        _second_point_hits(dev, tier, None)


# ---------------------------------------------------------------------------
# the key is content
# ---------------------------------------------------------------------------

def _edit_capacity(scn):
    scn.capacity[scn.routes[0, 0]] *= 0.5


def _edit_route(scn):
    scn.routes[0, 0] = scn.routes[1, 0]      # flows 0 and 1 share a wire


@pytest.mark.parametrize("edit", [_edit_capacity, _edit_route],
                         ids=["capacity", "route"])
def test_a_scenario_edited_in_place_misses(edit):
    sweep = _at(_base(), 1.0)
    # a built route table is read-only; a researcher's own copy is not
    p = sweep.points[0]
    sweep.points[0] = dataclasses.replace(p, scenario=p.scenario._replace(
        routes=p.scenario.routes.copy()))
    STAGE_CACHE.clear()
    before = _run(sweep)
    hit, _ = _hits(lambda: _run(sweep))
    assert hit > 0
    edit(sweep.points[0].scenario)
    hit, edited = _hits(lambda: _run(sweep))
    assert hit == 0
    assert _differ(edited, before)
    STAGE_CACHE.clear()
    assert_bitwise(edited, _run(sweep))


@pytest.mark.parametrize("change", [
    {"min_switches": 64}, {"dense_rows": 0}, {"trace_every": 20}],
    ids=["min_switches", "dense_rows", "trace_every"])
def test_another_static_argument_misses(change):
    sweep = _at(_base(), 1.0)
    STAGE_CACHE.clear()
    _run(sweep)
    assert _hits(lambda: _run(sweep))[0] > 0
    kw = dict(change)
    te = kw.pop("trace_every", TRACE)
    hit, res = _hits(lambda: sweep.run(N_STEPS, te, device="cpu", **kw))
    assert hit == 0
    assert _hits(lambda: sweep.run(N_STEPS, te, device="cpu", **kw))[0] > 0
    STAGE_CACHE.clear()
    assert_bitwise(res, sweep.run(N_STEPS, te, device="cpu", **kw))


def test_another_mesh_part_misses(monkeypatch):
    """A rank's slice is cut before its plan: ranks 0 and 1 of a mesh of
    two stage two entries (the mesh faked: the part is all the key and
    the cut read of it)."""
    part = [None]
    monkeypatch.setattr(experiments, "_mesh_shard", lambda mesh: part[0])
    monkeypatch.setattr(experiments, "_sweep_device",
                        lambda mesh, device: torch.device("cpu"))
    sweep = _at(_base(), 1.0)
    STAGE_CACHE.clear()
    staged = {}
    for rank in (0, 1):
        part[0] = (rank, 2)
        hit, staged[rank] = _hits(lambda: _prepare(sweep, mesh=object()))
        assert hit == 0
        assert staged[rank][1].sd.alt_routes.shape[0] == 2   # 3 pad to 4
        assert _hits(lambda: _prepare(sweep, mesh=object()))[0] > 0
    STAGE_CACHE.clear()
    _equal_inputs(staged[1], _prepare(sweep, mesh=object()))


# ---------------------------------------------------------------------------
# threads
# ---------------------------------------------------------------------------

def test_two_threads_at_two_points_keep_their_bits():
    base = _base()
    sweeps = [_at(base, s) for s in (0.5, 2.0)]
    STAGE_CACHE.clear()
    serial = [_run(s) for s in sweeps]
    assert _differ(*serial)
    STAGE_CACHE.clear()
    got = [[], []]
    errors, barrier = [], threading.Barrier(2)

    def body(i):
        try:
            barrier.wait()
            for _ in range(3):
                got[i].append(_run(sweeps[i]))
        except BaseException as e:       # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=body, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    for i in (0, 1):
        assert len(got[i]) == 3
        for res in got[i]:
            assert_bitwise(res, serial[i])
    assert len(STAGE_CACHE) == 1
