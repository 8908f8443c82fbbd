"""Grids and comparisons shared by the port's fleet, what-if and dist
tests (``tests/test_torch_{fleet,fleet_sched,whatif,dist}.py``)."""

import numpy as np

N_STEPS, TRACE_EVERY = 300, 50

#: the golden tolerances (tests/test_golden.py): floats rtol 2e-3,
#: counters within 2% or 2 events
FLOAT_KEYS = ("aggregate_gbps", "completion_ms", "delivered_mb",
              "peak_queue_kb")
COUNT_KEYS = ("marks", "cnps", "peak_nonmin_flows")

#: the reference fleet tests' ragged grid: mixed flow counts
RAGGED = {"i2": lambda S: S.incast(2, victim=False),
          "i6": lambda S: S.incast(6, victim=False),
          "hol": lambda S: S.paper_incast(roll=0)}
#: the grid the fleet runs execute: still ragged (2 and 5 flows), 6
#: points, so each fleet run stays a few seconds on the CPU
RUN = {"i2": RAGGED["i2"], "hol": RAGGED["hol"]}


def grid(core, scenarios: dict):
    """The three paper schemes x ``scenarios`` as a Sweep of ``core``
    (``repro.core`` or ``repro_torch.core``)."""
    return core.Sweep.grid(
        configs={s.name: core.PAPER_CONFIG.replace(scheme=s)
                 for s in core.CCScheme},
        scenarios={k: f(core.ScenarioSpec) for k, f in scenarios.items()})


def assert_bitwise(res, ref, fields=None):
    """Every trace field, the time base and the full final-state tree."""
    from repro_torch.core.serialize import _SIM_TRACE_FIELDS
    assert [p.name for p in res.points] == [p.name for p in ref.points]
    np.testing.assert_array_equal(res.times, ref.times)
    for f in fields or _SIM_TRACE_FIELDS:
        a, b = getattr(res.traces, f), getattr(ref.traces, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f)
    for f in res.final._fields:
        a, b = getattr(res.final, f), getattr(ref.final, f)
        if isinstance(a, dict):
            assert set(a) == set(b), f
            for k in a:
                np.testing.assert_array_equal(a[k], b[k],
                                              err_msg=f"final.cc.{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"final.{f}")


def assert_golden_close(got: dict, want: dict):
    """Two ``summary()`` dicts (name -> row) within the golden
    tolerances."""
    assert set(got) == set(want)
    for name, row in got.items():
        for k in FLOAT_KEYS:
            g, w = row[k], want[name][k]
            if np.isnan(w):
                assert np.isnan(g), (name, k, g)
                continue
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-9,
                                       err_msg=f"{name}.{k}")
        for k in COUNT_KEYS:
            g, w = row[k], want[name][k]
            assert abs(g - w) <= max(2, 0.02 * w), (name, k, g, w)
