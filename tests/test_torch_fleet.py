"""The port's fleet (``repro_torch.fleet``) against the reference's
contracts, on the CPU (the cases of ``tests/test_fleet.py``).

  * planning: the same shards and the same point, shard and plan digests
    as the reference's ``plan_sweep`` on the same sweep; one envelope
    bucket; fabric bucketing; shard sweeps and kwargs pin the envelope;
  * ``stream_sweep`` bitwise equal to the port's ``Sweep.run`` (every
    trace field and the final state), with and without a spill directory;
  * ``run_fleet`` bitwise equal to the port's ``Sweep.run``: threads,
    streaming, a lost worker and a preempt / resume cycle, one build of
    the batch's window; resume with zero recompute;
  * the port's merged result against the reference's fleet at the golden
    tolerances (rtol 2e-3, counters within 2% or 2).

The scheduler's outcomes are ``tests/test_torch_fleet_sched.py``; the
two-process ``torch.distributed`` leg is ``tests/test_torch_dist.py``.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

import repro.core as R                                       # noqa: E402
import repro.fleet as RF                                     # noqa: E402
import repro_torch.core as P                                 # noqa: E402
import repro_torch.fleet as PF                               # noqa: E402
from repro_torch.core import SWEEP_EXEC_CACHE                # noqa: E402
from repro_torch.fleet import (Done, FleetConfig,            # noqa: E402
                               FleetJournal, FleetRunner, PreemptedError,
                               WorkerLost, plan_sweep, run_fleet,
                               stream_sweep)
from _torch_sweeps import (N_STEPS, RAGGED, RUN,             # noqa: E402
                           TRACE_EVERY, assert_bitwise,
                           assert_golden_close, grid)


@pytest.fixture(scope="module")
def sweep():
    return grid(P, RUN)


@pytest.fixture(scope="module")
def ref(sweep):
    return sweep.run(n_steps=N_STEPS, trace_every=TRACE_EVERY, device="cpu")


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(n_shards=4), dict(n_shards=3),
                                dict(max_points=2),
                                dict(n_shards=4, bucket_by="fabric"),
                                dict(n_shards=2, use_kernels="mega",
                                     min_delay_slots=40, dense_rows=0)],
                         ids=["4", "3", "max2", "fabric", "mega"])
def test_plan_matches_reference(kw):
    """The same shard split, buckets and digests as the reference's
    planner on the same (ragged) sweep."""
    mine = plan_sweep(grid(P, RAGGED), N_STEPS, TRACE_EVERY, **kw)
    theirs = RF.plan_sweep(grid(R, RAGGED), N_STEPS, TRACE_EVERY, **kw)
    assert mine.digest == theirs.digest
    assert [(s.indices, s.names, s.bucket, s.digest) for s in mine.shards] \
        == [(s.indices, s.names, s.bucket, s.digest) for s in theirs.shards]
    assert [b.key() for b in mine.buckets] == \
        [b.key() for b in theirs.buckets]
    assert [RF.point_digest(p) for p in theirs.sweep.points] == \
        [PF.point_digest(p) for p in mine.sweep.points]
    # costs are the reference's model at the H100's bandwidth
    ratio = RF.plan.HBM_BW / PF.plan.HBM_BW
    for a, b in zip(mine.shards, theirs.shards):
        assert a.cost == pytest.approx(b.cost * ratio, rel=1e-12)


def test_plan_deterministic_and_content_addressed(sweep):
    p1 = plan_sweep(sweep, N_STEPS, TRACE_EVERY, n_shards=4)
    p2 = plan_sweep(sweep, N_STEPS, TRACE_EVERY, n_shards=4)
    assert p1.digest == p2.digest
    assert [s.digest for s in p1.shards] == [s.digest for s in p2.shards]
    p3 = plan_sweep(sweep, N_STEPS * 2, TRACE_EVERY, n_shards=4)
    assert p3.digest != p1.digest
    assert all(s3.digest != s1.digest
               for s1, s3 in zip(p1.shards, p3.shards))
    seen = sorted(i for s in p1.shards for i in s.indices)
    assert seen == list(range(len(sweep.points)))
    # the device is where shards run, not part of the work's identity
    p4 = plan_sweep(sweep, N_STEPS, TRACE_EVERY, n_shards=4, device="cpu")
    assert p4.digest == p1.digest and p4.device == "cpu"


def test_plan_envelope_is_one_bucket(sweep):
    plan = plan_sweep(sweep, N_STEPS, TRACE_EVERY, n_shards=4)
    assert len(plan.buckets) == 1 and len(plan.shards) >= 3
    b = plan.buckets[0]
    assert b.n_flows >= max(p.scenario.routes.shape[0]
                            for p in sweep.points)
    assert max(s.cost for s in plan.shards) < plan.total_cost


def test_shard_sweep_and_kwargs_pin_the_envelope(sweep):
    plan = plan_sweep(sweep, N_STEPS, TRACE_EVERY, n_shards=4,
                      device="cpu")
    b = plan.buckets[0]
    for s in plan.shards:
        for p in plan.shard_sweep(s).points:
            assert p.scenario.routes.shape == (b.n_flows, b.n_hops)
        kw = plan.run_kwargs(s)
        assert kw["pad_runs_to"] == b.width
        assert kw["min_switches"] == b.n_switches
        assert kw["min_delay_slots"] == b.delay_slots
        assert kw["device"] == "cpu" and "interpret" not in kw


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------


def test_stream_sweep_bitwise(sweep, ref):
    res = stream_sweep(sweep, n_steps=N_STEPS, trace_every=TRACE_EVERY,
                       device="cpu")
    assert_bitwise(res, ref)


def test_stream_sweep_spill_dir(tmp_path, sweep, ref):
    res = stream_sweep(sweep, n_steps=N_STEPS, trace_every=TRACE_EVERY,
                       spill_dir=str(tmp_path / "spill"), buffer_windows=1,
                       device="cpu")
    assert_bitwise(res, ref)
    assert (tmp_path / "spill" / "delivered.npy").exists()
    with pytest.raises(ValueError, match="buffer_windows"):
        stream_sweep(sweep, N_STEPS, buffer_windows=0, device="cpu")


def test_stream_sweep_spiller_error_surfaces(sweep, monkeypatch):
    """A spiller that dies stops the producer and its error is raised."""
    from repro_torch.fleet import stream as ST

    def boom(self, t, window):
        raise OSError("disk full")

    monkeypatch.setattr(ST._Spill, "write", boom)
    with pytest.raises(OSError, match="disk full"):
        stream_sweep(sweep, N_STEPS, TRACE_EVERY, device="cpu")


# ---------------------------------------------------------------------------
# the acceptance run
# ---------------------------------------------------------------------------


def test_fleet_acceptance_bitwise(tmp_path, sweep, ref):
    """Threads + ragged shards + streaming + one lost worker + one
    preempt / resume cycle == one launch, bitwise, one window build."""
    plan = plan_sweep(sweep, N_STEPS, TRACE_EVERY, n_shards=4,
                      device="cpu")
    assert len(plan.shards) >= 3
    journal = str(tmp_path / "journal")
    killed = []

    def fault(shard, attempt, worker):
        if shard.index == 1 and not killed:
            killed.append(worker)
            raise WorkerLost(f"chaos: worker {worker} dies")

    misses0 = SWEEP_EXEC_CACHE.stats().misses
    with pytest.raises(PreemptedError):
        FleetRunner(plan, FleetConfig(n_workers=3, preempt_after=2),
                    journal=journal, fault_hook=fault).run()
    assert killed, "the chaos hook never fired"
    committed = len(FleetJournal(journal).completed())
    assert committed >= 2
    out = FleetRunner(plan, FleetConfig(n_workers=3),
                      journal=journal).run()
    assert out.stats.resumed == committed and out.stats.abandoned == 0
    # one bucket: one window entry across both phases (a hit of the
    # reference run's entry is none: its batch is wider)
    assert SWEEP_EXEC_CACHE.stats().misses - misses0 <= 1
    assert out.stats.compiles == 0
    assert_bitwise(out.result, ref)
    resumed = [o for o in out.outcomes.values()
               if isinstance(o, Done) and o.resumed]
    assert len(resumed) == committed


def test_fleet_unjournaled_run_bitwise(sweep, ref):
    out = run_fleet(sweep, N_STEPS, TRACE_EVERY,
                    config=FleetConfig(n_workers=2, n_shards=3,
                                       stream=False), device="cpu")
    assert_bitwise(out.result, ref)
    assert all(isinstance(o, Done) for o in out.outcomes.values())


def test_fleet_resume_zero_recompute(tmp_path, sweep, ref):
    journal = str(tmp_path / "journal")
    cfg = FleetConfig(n_workers=2, n_shards=3)
    run_fleet(sweep, N_STEPS, TRACE_EVERY, config=cfg, journal=journal,
              device="cpu")
    misses0 = SWEEP_EXEC_CACHE.stats().misses
    out = run_fleet(sweep, N_STEPS, TRACE_EVERY, config=cfg,
                    journal=journal, device="cpu")
    assert out.stats.executed == 0
    assert out.stats.resumed == len(out.plan.shards)
    assert SWEEP_EXEC_CACHE.stats().misses == misses0
    assert_bitwise(out.result, ref)


def test_fleet_matches_reference_fleet(sweep, ref):
    """The port's merged fleet result against the reference's fleet on
    the same grid, at the golden tolerances."""
    out = run_fleet(sweep, N_STEPS, TRACE_EVERY,
                    config=FleetConfig(n_workers=2, n_shards=3),
                    device="cpu")
    theirs = RF.run_fleet(grid(R, RUN), N_STEPS, TRACE_EVERY,
                          config=FleetConfig(n_workers=2, n_shards=3))
    assert_golden_close(out.result.summary(), theirs.result.summary())
