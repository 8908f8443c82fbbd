"""The port's what-if query engine (``repro_torch.serve.whatif``) on the
CPU, case by case against ``tests/test_whatif_engine.py``: the front door
and the roads a batch takes.

  * admission: the token bucket, rate 0, a full queue keeping its token,
    per-tenant isolation — and the port's controller and engine give the
    reference's outcomes on one fake clock (the serve bench's burst probe
    among them);
  * ``flow_bucket`` and signature grouping (the reference's ``interpret``
    is the engine's device); the card by default;
  * ``auto_drain`` bitwise equal to the sync path; ``close`` drains;
    fleet delegation bitwise and flagged; the megakernel tier.

The replay is ``tests/test_torch_whatif.py``.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

import repro.core as R                                       # noqa: E402
import repro.serve.whatif as RW                              # noqa: E402
import repro_torch.serve.whatif as W                         # noqa: E402
from repro_torch.core import CCSpec, ScenarioSpec            # noqa: E402
from repro_torch.serve.whatif import (AdmissionConfig,       # noqa: E402
                                      AdmissionController, Admitted,
                                      CCQueryEngine, EngineConfig,
                                      LatencyRecorder, QueueFull,
                                      Throttled, TokenBucket, WhatIfQuery,
                                      flow_bucket)
from test_torch_whatif import (N_STEPS, OPEN, PORT_CFGS,     # noqa: E402
                               PORT_SPECS, _assert_same, _engine, _query,
                               _solo)


# ---------------------------------------------------------------------------
# structural signatures
# ---------------------------------------------------------------------------


def test_flow_bucket():
    assert [flow_bucket(n) for n in (1, 4, 5, 8, 9, 16)] == \
        [4, 4, 8, 8, 16, 16]
    assert flow_bucket(3, minimum=2) == 4
    assert all(flow_bucket(n, m) == RW.flow_bucket(n, m)
               for n in range(1, 70) for m in (1, 2, 4, 5))


def test_signature_sharing_and_separation():
    eng = _engine()

    def sig(**kw):
        q = dict(cfg=PORT_CFGS["rev"], scenario=PORT_SPECS["in4"],
                 n_steps=N_STEPS)
        q.update(kw)
        return eng._prepare(WhatIfQuery(**q)).sig

    base = sig()
    assert base.device == "cpu" and base.flows == 8
    assert sig(cfg=PORT_CFGS["swift"]) == base
    assert sig(scenario=PORT_SPECS["in7"]) == base
    assert sig(scenario=ScenarioSpec.permutation(16)) != base
    assert sig(trace_every=2) != base
    k2 = sig(scenario=dataclasses.replace(PORT_SPECS["in4"], n_paths=2))
    assert k2 != base and k2.paths == 2
    wide = sig(scenario=dataclasses.replace(PORT_SPECS["in4"], arity=6))
    assert wide != base and wide.links != base.links
    mega = _engine(use_kernels="mega")._prepare(_query()).sig
    assert mega != base and mega.use_kernels == "mega"
    # the reference's fields, with its interpret flag as the device
    names = [f.name for f in dataclasses.fields(W.StructuralSignature)]
    want = [f.name for f in dataclasses.fields(RW.StructuralSignature)]
    assert names == [("device" if n == "interpret" else n) for n in want]


def test_rejected_scenario_type_and_missing_card():
    with pytest.raises(TypeError, match="ScenarioSpec"):
        WhatIfQuery(cfg=CCSpec(), scenario=PORT_SPECS["in4"].build(CCSpec()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CCQueryEngine()                       # the card by default


# ---------------------------------------------------------------------------
# admission: token bucket + bounded queue
# ---------------------------------------------------------------------------


def test_token_bucket_burst_then_refill():
    b = TokenBucket(rate=2.0, burst=3, now=0.0)
    assert [b.take(0.0) for _ in range(4)] == [True, True, True, False]
    assert b.retry_after(0.0) == pytest.approx(0.5)
    assert b.take(0.25) is False
    assert b.take(0.5) is True
    assert b.retry_after(10.0) == 0.0


def test_token_bucket_rate_zero_never_refills():
    b = TokenBucket(rate=0.0, burst=1, now=0.0)
    assert b.take(0.0) is True
    assert b.take(1e9) is False
    assert b.retry_after(1e9) == float("inf")


def test_admission_queue_full_preserves_token():
    t = [0.0]
    ctl = AdmissionController(AdmissionConfig(rate=0.0, burst=1,
                                              max_queue=1),
                              clock=lambda: t[0])
    out = ctl.admit("a", queue_depth=1)
    assert isinstance(out, QueueFull) and out.queue_depth == 1
    assert ctl.admit("a", queue_depth=0) is None
    assert isinstance(ctl.admit("a", queue_depth=0), Throttled)
    assert ctl.counters() == {"admitted": 1, "throttled": 1,
                              "queue_full": 1, "tenants": 1}


def test_admission_per_tenant_isolation():
    t = [0.0]
    ctl = AdmissionController(AdmissionConfig(rate=0.0, burst=2,
                                              max_queue=99),
                              clock=lambda: t[0])
    assert ctl.admit("noisy", 0) is None and ctl.admit("noisy", 0) is None
    assert isinstance(ctl.admit("noisy", 0), Throttled)
    assert ctl.admit("quiet", 0) is None


def _outcome(o):
    return None if o is None else (type(o).__name__,
                                   dataclasses.asdict(o))


def test_admission_outcomes_equal_the_reference():
    """One seeded stream of (time, tenant, queue depth) through both
    controllers on one fake clock: the same outcomes, in order."""
    rng = np.random.RandomState(0)
    cfg = dict(rate=7.0, burst=3, max_queue=5)
    clocks = [[0.0], [0.0]]
    mine = AdmissionController(AdmissionConfig(**cfg),
                               clock=lambda: clocks[0][0])
    theirs = RW.AdmissionController(RW.AdmissionConfig(**cfg),
                                    clock=lambda: clocks[1][0])
    for _ in range(400):
        dt = float(rng.exponential(0.05))
        tenant = f"t{rng.randint(3)}"
        depth = int(rng.randint(8))
        for c in clocks:
            c[0] += dt
        assert _outcome(mine.admit(tenant, depth)) == \
            _outcome(theirs.admit(tenant, depth))
    assert mine.counters() == theirs.counters()
    with pytest.raises(ValueError):
        AdmissionConfig(rate=-1.0)


def test_engine_throttles_over_rate_burst():
    t = [0.0]
    eng = CCQueryEngine(
        EngineConfig(admission=AdmissionConfig(rate=10.0, burst=4,
                                               max_queue=64),
                     device="cpu"), clock=lambda: t[0])
    outs = [eng.submit(_query()) for _ in range(6)]
    assert [type(o) for o in outs] == [Admitted] * 4 + [Throttled] * 2
    assert outs[4].retry_after == pytest.approx(0.1)
    t[0] += outs[4].retry_after
    assert isinstance(eng.submit(_query()), Admitted)
    assert eng.metrics()["admission"]["throttled"] == 2
    assert eng.metrics()["queue_depth"] == 5


def test_engine_outcomes_equal_the_reference():
    """The front door of both engines on one fake clock: a burst of 16
    (the serve bench's probe: 4 admitted, 12 throttled), a refill, then
    a full queue."""
    t = [0.0]
    adm = dict(rate=10.0, burst=4, max_queue=6)
    mine = CCQueryEngine(EngineConfig(admission=AdmissionConfig(**adm),
                                      device="cpu"), clock=lambda: t[0])
    theirs = RW.CCQueryEngine(RW.EngineConfig(
        admission=RW.AdmissionConfig(**adm)), clock=lambda: t[0])
    rq = RW.WhatIfQuery(cfg=R.CCSpec(), scenario=R.ScenarioSpec.incast(4),
                        n_steps=N_STEPS)
    seq = []
    for step in [0.0] * 16 + [0.5] * 4 + [0.0] * 4:
        t[0] += step
        a, b = mine.submit(_query()), theirs.submit(rq)
        assert _outcome(a) == _outcome(b)
        seq.append(type(a).__name__)
    assert seq[:16] == ["Admitted"] * 4 + ["Throttled"] * 12
    assert "QueueFull" in seq
    assert mine.metrics()["admission"] == theirs.metrics()["admission"]


def test_engine_queue_never_unbounded():
    eng = CCQueryEngine(
        EngineConfig(admission=AdmissionConfig(rate=1e9, burst=10_000,
                                               max_queue=8),
                     device="cpu"), clock=lambda: 0.0)
    outs = [eng.submit(_query()) for _ in range(20)]
    assert sum(isinstance(o, Admitted) for o in outs) == 8
    assert all(isinstance(o, QueueFull) for o in outs[8:])
    assert eng.metrics()["queue_depth"] == 8


def test_latency_recorder_percentiles():
    r = LatencyRecorder()
    assert np.isnan(r.percentile(50))
    for v in [0.1, 0.2, 0.3, 0.4, 1.0]:
        r.record(v)
    assert r.percentile(0) == 0.1
    assert r.percentile(50) == 0.3
    assert r.percentile(100) == 1.0
    s = r.summary()
    assert s["count"] == 5 and s["p99"] == 1.0


# ---------------------------------------------------------------------------
# background drain, fleet delegation, the megakernel tier
# ---------------------------------------------------------------------------


def test_auto_drain_serves_and_closes_cleanly():
    with CCQueryEngine(EngineConfig(max_batch=8,
                                    admission=AdmissionConfig(**OPEN),
                                    device="cpu"),
                       auto_drain=True) as eng:
        tickets = []

        def sub(i):
            out = eng.submit(_query(label=f"bg{i}"))
            assert isinstance(out, Admitted), out
            tickets.append(out.ticket)

        threads = [threading.Thread(target=sub, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [eng.wait(t, timeout=600) for t in tickets]
        assert all(r is not None for r in results)
        assert eng.metrics()["queue_depth"] == 0
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(_query())


def test_auto_drain_bitwise_matches_sync_path():
    r_sync = _engine().ask(_query("dcqcn", "in6"))
    with CCQueryEngine(EngineConfig(max_batch=8,
                                    admission=AdmissionConfig(**OPEN),
                                    device="cpu"),
                       auto_drain=True) as eng:
        r_bg = eng.ask(_query("dcqcn", "in6"))
    _assert_same(r_bg.result, r_sync.result)


def test_close_drains_pending_queries():
    eng = _engine()
    out = eng.submit(_query())
    assert isinstance(out, Admitted)
    eng.close()
    assert eng.result(out.ticket) is not None


def test_fleet_delegation_bitwise_and_flagged():
    r_in = _engine().ask(_query("swift"))
    assert r_in.via_fleet is False
    r_fl = _engine(fleet_threshold=0.0).ask(_query("swift"))
    assert r_fl.via_fleet is True and r_fl.to_dict()["via_fleet"] is True
    _assert_same(r_fl.result, r_in.result)


def test_fleet_threshold_none_never_delegates():
    assert _engine().ask(_query()).via_fleet is False


def test_mega_tier_query_matches_standalone():
    """``use_kernels="mega"`` (on the CPU its plain version) answers as a
    standalone mega Sweep does, and as the flow tier does."""
    r = _engine(use_kernels="mega").ask(_query("swift", "in7"))
    _assert_same(r.result, _solo("swift", "in7", use_kernels="mega"))
    _assert_same(r.result, _solo("swift", "in7"))
