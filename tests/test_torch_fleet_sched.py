"""The port's fleet scheduler (``repro_torch.fleet.scheduler`` and
``resume``) on the CPU: the reference's scheduler cases
(``tests/test_fleet.py``).

  * work stealing levels ragged shards over two workers;
  * a lost worker's shard is requeued for the survivors; a transient
    failure is retried; a permanent one is abandoned explicitly (strict
    mode raises, after merging what completed); every worker lost
    abandons the rest;
  * the journal refuses a foreign plan; claims are exclusive; the
    distributed backend's coordinator steals a dead worker's stale claim
    and runs the shard (single process: ``process_info`` is (0, 1)).

Every completed merge is bitwise equal to the port's ``Sweep.run``.
"""

import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

import repro_torch.core as P                                 # noqa: E402
from repro_torch.fleet import (Abandoned, DistributedBackend,  # noqa: E402
                               Done, FleetConfig, FleetError, FleetJournal,
                               FleetRunner, Retried, WorkerLost, plan_sweep,
                               run_fleet)
from _torch_sweeps import (N_STEPS, RUN, TRACE_EVERY,        # noqa: E402
                           assert_bitwise, grid)


@pytest.fixture(scope="module")
def sweep():
    return grid(P, RUN)


@pytest.fixture(scope="module")
def ref(sweep):
    return sweep.run(n_steps=N_STEPS, trace_every=TRACE_EVERY, device="cpu")



def test_work_stealing_levels_ragged_shards(sweep, ref):
    out = run_fleet(sweep, N_STEPS, TRACE_EVERY,
                    config=FleetConfig(n_workers=2, n_shards=4),
                    device="cpu")
    assert_bitwise(out.result, ref)
    workers = {o.worker for o in out.outcomes.values()
               if isinstance(o, (Done, Retried))}
    assert len(workers) == 2, "one worker served the whole fleet"


def test_worker_lost_requeues_for_survivors(sweep, ref):
    killed = []

    def fault(shard, attempt, worker):
        if shard.index == 0 and not killed:
            killed.append(worker)
            raise WorkerLost("chaos")

    out = run_fleet(sweep, N_STEPS, TRACE_EVERY,
                    config=FleetConfig(n_workers=2, n_shards=3),
                    fault_hook=fault, device="cpu")
    assert killed
    assert_bitwise(out.result, ref)
    o = out.outcomes[0]
    assert isinstance(o, Retried) and o.worker != killed[0]


def test_retry_then_succeed(sweep, ref):
    attempts = []

    def fault(shard, attempt, worker):
        if shard.index == 0 and attempt == 1:
            attempts.append(attempt)
            raise RuntimeError("transient")

    out = run_fleet(sweep, N_STEPS, TRACE_EVERY,
                    config=FleetConfig(n_workers=2, n_shards=3,
                                       backoff_s=0.0),
                    fault_hook=fault, device="cpu")
    assert attempts
    o = out.outcomes[0]
    assert isinstance(o, Retried) and o.attempts == 2 and o.errors
    assert out.stats.retries == 1
    assert_bitwise(out.result, ref)


def test_abandoned_is_explicit_and_strict_raises(sweep):
    def fault(shard, attempt, worker):
        if shard.index == 0:
            raise RuntimeError("permanent")

    cfg = dict(n_workers=2, n_shards=3, max_retries=1, backoff_s=0.0)
    with pytest.raises(FleetError, match="abandoned"):
        run_fleet(sweep, N_STEPS, TRACE_EVERY, config=FleetConfig(**cfg),
                  fault_hook=fault, device="cpu")
    out = run_fleet(sweep, N_STEPS, TRACE_EVERY,
                    config=FleetConfig(strict=False, **cfg),
                    fault_hook=fault, device="cpu")
    bad = out.abandoned
    assert len(bad) == 1 and bad[0].shard == 0
    assert bad[0].attempts == 2 and bad[0].errors
    covered = {n for s in out.plan.shards if s.index != 0
               for n in s.names}
    assert {p.name for p in out.result.points} == covered


def test_all_workers_lost_abandons_remainder(sweep):
    def fault(shard, attempt, worker):
        raise WorkerLost("everyone dies")

    out = run_fleet(sweep, N_STEPS, TRACE_EVERY,
                    config=FleetConfig(n_workers=2, n_shards=3,
                                       strict=False),
                    fault_hook=fault, device="cpu")
    assert out.result is None
    assert all(isinstance(o, Abandoned) for o in out.outcomes.values())
    assert len(out.outcomes) == len(out.plan.shards)


def test_journal_rejects_foreign_plan(tmp_path, sweep):
    plan = plan_sweep(sweep, N_STEPS, TRACE_EVERY, n_shards=3)
    other = plan_sweep(sweep, N_STEPS * 2, TRACE_EVERY, n_shards=3)
    jr = FleetJournal(str(tmp_path))
    jr.bind(plan)
    with pytest.raises(ValueError, match="bound to plan"):
        jr.bind(other)


def test_journal_claims_are_exclusive(tmp_path):
    jr = FleetJournal(str(tmp_path))
    assert jr.claim("d1", "a")
    assert not jr.claim("d1", "b")
    assert jr.claim_age("d1") is not None
    jr.steal_claim("d1", "b")
    jr.release("d1")
    assert jr.claim_age("d1") is None
    assert jr.failures("d1") == 0
    assert jr.record_failure("d1", "boom") == 1
    assert jr.record_failure("d1", "boom again") == 2
    assert jr.failures("d1") == 2


def test_coordinator_reclaims_dead_workers_claim(tmp_path, sweep, ref):
    """A dead worker's stale claim is stolen by the coordinator, which
    runs the shard itself; single-process, ``process_info`` is (0, 1)."""
    plan = plan_sweep(sweep, N_STEPS, TRACE_EVERY, n_shards=3,
                      device="cpu")
    jr = FleetJournal(str(tmp_path / "journal"))
    jr.bind(plan)
    victim = plan.shards[0]
    assert jr.claim(victim.digest, "dead-proc")
    os.utime(os.path.join(jr.claims_dir, victim.digest), (1.0, 1.0))
    out = FleetRunner(plan, FleetConfig(claim_timeout_s=30.0,
                                        timeout_s=300.0, poll_s=0.05),
                      backend=DistributedBackend(jr), journal=jr).run()
    assert out.stats.abandoned == 0
    assert out.stats.stolen >= 1
    assert_bitwise(out.result, ref)
    with pytest.raises(ValueError, match="journal"):
        FleetRunner(plan, backend=DistributedBackend(jr))
