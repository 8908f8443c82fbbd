"""The port's what-if query engine (``repro_torch.serve.whatif``) on the
CPU, case by case against ``tests/test_whatif_engine.py``: the replay.

  * a replay of 48 mixed queries builds one window (a miss, then hits:
    on the card one CUDA-graph capture), every answer bitwise equal to a
    standalone port ``Sweep.run(device="cpu")`` of its point;
  * the port's answers against the reference engine's at the golden
    tolerances (rtol 2e-3, counters within 2% or 2).

The front door, signatures, ``auto_drain``, fleet delegation and the
megakernel tier are ``tests/test_torch_whatif_front.py``.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

import repro.core as R                                       # noqa: E402
import repro.serve.whatif as RW                              # noqa: E402
from repro_torch.core import (CCSpec, SWEEP_EXEC_CACHE,      # noqa: E402
                              ScenarioSpec, Sweep)
from repro_torch.serve.whatif import (AdmissionConfig,       # noqa: E402
                                      Admitted, CCQueryEngine,
                                      EngineConfig, WhatIfQuery)
from _torch_sweeps import assert_golden_close                # noqa: E402

N_STEPS = 240
REPLAY = 48

#: the reference's fixed-pod mix: three workloads in one flow bucket (8)
#: x four CC stacks, built for either package
SPECS = {"in4": lambda S: S.incast(4), "in6": lambda S: S.incast(6),
         "in7": lambda S: S.incast(7)}
CFGS = {"rev": lambda C: C(),
        "dcqcn": lambda C: C(marking="cp", notification="np",
                             reaction="rp"),
        "swift": lambda C: C(reaction="swift"),
        "rev-tuned": lambda C: C().replace(
            rev=dataclasses.replace(C().rev, erp_settle=0.9))}
PORT_SPECS = {k: f(ScenarioSpec) for k, f in SPECS.items()}
PORT_CFGS = {k: f(CCSpec) for k, f in CFGS.items()}
OPEN = dict(rate=1e9, burst=10_000, max_queue=256)


def _engine(**cfg):
    adm = AdmissionConfig(**OPEN)
    return CCQueryEngine(EngineConfig(max_batch=8, admission=adm,
                                      device="cpu", **cfg))


def _query(cn="rev", sn="in4", **kw):
    return WhatIfQuery(cfg=PORT_CFGS[cn], scenario=PORT_SPECS[sn],
                       n_steps=N_STEPS, **kw)


def _solo(cn, sn, **kw):
    return Sweep([("p", PORT_CFGS[cn], PORT_SPECS[sn])]).run(
        n_steps=N_STEPS, device="cpu", **kw)["p"]


FIELDS = ("delivered", "rate", "inst_thr", "max_q", "n_paused", "marked",
          "cnp", "n_nonmin", "times")


def _assert_same(got, want, where=""):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{where}:{f}")
    for f in got.final._fields:
        a, b = getattr(got.final, f), getattr(want.final, f)
        for k, v in (a.items() if isinstance(a, dict) else [("", a)]):
            w = b[k] if isinstance(b, dict) else b
            np.testing.assert_array_equal(np.asarray(v), np.asarray(w),
                                          err_msg=f"{where}:final.{f}{k}")


# ---------------------------------------------------------------------------
# the replay
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def replay():
    """REPLAY mixed queries over a fixed pod, drained in four waves (the
    reference replays 100; 48 keep this file's CPU time down, and
    chip_smoke replays 96 on the card)."""
    SWEEP_EXEC_CACHE.clear()
    eng = _engine()
    mix = [(cn, sn) for cn in CFGS for sn in SPECS]          # 12 combos
    tickets = {}
    for i in range(REPLAY):
        cn, sn = mix[i % len(mix)]
        out = eng.submit(_query(cn, sn, label=f"{cn}/{sn}"))
        assert isinstance(out, Admitted), out
        tickets[out.ticket] = (cn, sn)
        if (i + 1) % (REPLAY // 4) == 0:
            eng.drain()
    eng.drain()
    return eng, tickets


def test_replay_builds_once(replay):
    """One structural signature => one window build (on the card one
    capture), every later batch a hit."""
    eng, _ = replay
    m = eng.metrics()
    assert m["queries"] == REPLAY
    assert m["exec_cache"]["misses"] == 1, m["exec_cache"]
    assert m["exec_cache"]["hits"] == m["batches"] - 1
    assert m["signatures"] == 1
    assert m["compile_s"] >= 0


def test_replay_bitwise_matches_standalone_sweep(replay):
    eng, tickets = replay
    solo = {}
    for ticket, key in tickets.items():
        if key not in solo:
            solo[key] = _solo(*key)
        _assert_same(eng.result(ticket).result, solo[key], "/".join(key))


def test_identical_queries_identical_results(replay):
    eng, tickets = replay
    per_combo = {}
    for ticket, key in tickets.items():
        per_combo.setdefault(key, []).append(ticket)
    dup = next(ts for ts in per_combo.values() if len(ts) > 1)
    a, b = (eng.result(t).result for t in dup[:2])
    np.testing.assert_array_equal(a.delivered, b.delivered)
    np.testing.assert_array_equal(a.max_q, b.max_q)


def test_replay_metrics_shape(replay):
    eng, _ = replay
    m = eng.metrics()
    assert {"queries", "batches", "mean_occupancy", "run_s",
            "latency_s", "queue_wait_s", "exec_cache", "compile_s",
            "admission", "queue_depth", "signatures",
            "batch_width"} <= set(m)
    assert m["latency_s"]["count"] == REPLAY
    assert m["latency_s"]["p99"] >= m["latency_s"]["p50"] > 0
    assert 0 < m["mean_occupancy"] <= 1
    assert m["queue_depth"] == 0
    assert m["admission"]["admitted"] == REPLAY
    json.dumps(m)


def test_query_result_to_dict_json_ready(replay):
    eng, tickets = replay
    qr = eng.result(next(iter(tickets)))
    d = qr.to_dict()
    json.dumps(d)
    assert d["batch_width"] == 8 and d["summary"]["delivered_mb"] >= 0
    full = qr.to_dict(traces=True)
    json.dumps(full)
    assert "result" in full


def test_answers_match_the_reference_engine(replay):
    """One query per (CC stack, workload) through the reference's engine
    (JAX, CPU): the port's answers within the golden tolerances."""
    eng, tickets = replay
    ref = RW.CCQueryEngine(RW.EngineConfig(
        max_batch=8, admission=RW.AdmissionConfig(**OPEN)))
    want, got = {}, {}
    for ticket, (cn, sn) in tickets.items():
        name = f"{cn}/{sn}"
        if name in got:
            continue
        got[name] = eng.result(ticket).result.summary()
        out = ref.submit(RW.WhatIfQuery(
            cfg=CFGS[cn](R.CCSpec), scenario=SPECS[sn](R.ScenarioSpec),
            n_steps=N_STEPS, label=name))
        want[out.ticket] = name
    answered = {want[qr.ticket]: qr.result.summary() for qr in ref.drain()}
    assert_golden_close(got, answered)
