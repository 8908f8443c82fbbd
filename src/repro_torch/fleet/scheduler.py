"""Queue-based load-leveling coordinator for fleet shards (port of
``repro.fleet.scheduler``).

One :class:`Backend` protocol, two implementations:

  * :class:`ThreadBackend` — single-host worker threads over per-worker
    deques.  Shards are dealt by longest-processing-time on the plan's
    roofline costs; an idle worker STEALS from the busiest remaining
    deque's tail, so ragged grids level out at runtime instead of
    waiting on the slowest static assignment.  On one card the workers'
    device sections run one at a time (each holds the card's lock,
    ``kernels.capture.card_lock``), while one worker's host work —
    padding a shard, the spiller's writes, journaling — overlaps another
    worker's device work.
  * :class:`DistributedBackend` — ``torch.distributed`` processes sharing
    a :class:`~repro_torch.fleet.resume.FleetJournal`.  Ownership is an
    O_EXCL claim file per shard digest (claim-race = cross-process work
    stealing), completion is the journal's atomic ckpt commit, and the
    coordinator (process 0) reclaims stale claims from dead workers.

Failure model — a lost worker never silently drops grid points:

  * every shard ends in an explicit terminal outcome: :class:`Done`
    (first try), :class:`Retried` (succeeded after >= 1 failure, the
    errors attached) or :class:`Abandoned` (failed ``max_retries`` + 1
    times, the errors attached);
  * worker loss (:class:`WorkerLost` — raised by a fault hook in tests,
    or by a backend detecting a dead peer) requeues the in-flight shard
    for the survivors and retires the worker; if every worker dies the
    coordinator abandons the remainder EXPLICITLY;
  * retries back off linearly (``backoff_s`` x attempt) and are bounded
    (``max_retries``); ``strict`` (default) raises :class:`FleetError`
    if anything was abandoned, after merging what completed.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Optional, Protocol, Sequence

from ..core.experiments import SWEEP_EXEC_CACHE, Sweep, SweepResult
from ..core.serialize import merge_sweepresults

from .plan import FleetPlan, ShardSpec, plan_sweep
from .resume import FleetJournal
from .stream import stream_sweep


class WorkerLost(RuntimeError):
    """The executing worker died (injected by fault hooks in tests):
    the shard is requeued for the survivors; the worker leaves the
    pool."""


class PreemptedError(RuntimeError):
    """The run was preempted (``FleetConfig.preempt_after`` chaos knob):
    completed shards are journaled; resume with the same plan+journal."""


class FleetError(RuntimeError):
    """Strict-mode failure: one or more shards were abandoned."""


# -- terminal outcomes ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Done:
    """Shard completed on the first attempt (or straight from the
    journal: ``resumed=True``, zero recompute)."""

    shard: int
    digest: str
    attempts: int
    worker: int                    # -1: journal resume / remote process
    wall_s: float
    resumed: bool = False


@dataclasses.dataclass(frozen=True)
class Retried:
    """Shard completed after >= 1 failed attempt (errors attached)."""

    shard: int
    digest: str
    attempts: int
    worker: int
    wall_s: float
    errors: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Abandoned:
    """Shard failed every allowed attempt — its grid points are NOT in
    the merged result, and strict mode raises on it."""

    shard: int
    digest: str
    attempts: int
    errors: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs for one fleet run (planning + scheduling + streaming)."""

    n_workers: int = 2
    n_shards: int | None = None      # default: ~4 points per shard
    max_points: int | None = None    # alternative sizing: points/shard
    bucket_by: str = "envelope"
    stream: bool = True              # per-window device->host streaming
    buffer_windows: int = 2
    max_retries: int = 2
    backoff_s: float = 0.02
    strict: bool = True              # raise FleetError on any Abandoned
    preempt_after: int | None = None   # kill the run after N commits
    claim_timeout_s: float = 300.0   # distributed: stale-claim reclaim
    poll_s: float = 0.2              # distributed: coordinator poll
    timeout_s: float = 900.0         # distributed: coordinator wait cap


@dataclasses.dataclass
class FleetStats:
    n_shards: int = 0
    executed: int = 0               # shards actually run here
    resumed: int = 0                # shards loaded from the journal
    stolen: int = 0                 # work-steal events (threads)
    retries: int = 0                # failed attempts that were retried
    abandoned: int = 0
    compiles: int = 0               # SWEEP_EXEC_CACHE misses this run (on
    #                                 the card: CUDA-graph captures)
    wall_s: float = 0.0
    exec_s: float = 0.0             # sum of per-shard execution walls

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FleetResult:
    """The merged grid result + per-shard accounting."""

    result: SweepResult | None      # None: non-coordinator process, or
    outcomes: dict[int, object]     # nothing completed
    stats: FleetStats
    plan: FleetPlan

    @property
    def abandoned(self) -> list[Abandoned]:
        return [o for o in self.outcomes.values()
                if isinstance(o, Abandoned)]


#: run_fn(shard) -> SweepResult; on_result(shard, result, outcome) ->
#: False to stop scheduling (preemption), anything else to continue.
RunFn = Callable[[ShardSpec], SweepResult]
OnResult = Callable[[ShardSpec, SweepResult, object], Optional[bool]]
FaultHook = Callable[[ShardSpec, int, int], None]


class Backend(Protocol):
    """A shard-execution substrate: runs every shard to a terminal
    outcome (or stops early when ``on_result`` returns False)."""

    name: str

    def execute(self, shards: Sequence[ShardSpec], run_fn: RunFn,
                on_result: OnResult, config: FleetConfig,
                fault_hook: FaultHook | None = None,
                ) -> tuple[dict[int, object], dict]:
        ...


# -- single-host threads ----------------------------------------------------


class ThreadBackend:
    """Worker threads + per-worker deques + tail stealing."""

    name = "threads"

    def __init__(self, n_workers: int = 2):
        self.n_workers = max(1, int(n_workers))

    def execute(self, shards, run_fn, on_result, config,
                fault_hook=None):
        W = self.n_workers
        cv = threading.Condition()
        deques = [collections.deque() for _ in range(W)]
        loads = [0.0] * W
        # LPT deal: heaviest shard to the lightest deque
        for s in sorted(shards, key=lambda s: (-s.cost, s.index)):
            w = min(range(W), key=lambda j: (loads[j], j))
            deques[w].append(s)
            loads[w] += s.cost
        outcomes: dict[int, object] = {}
        attempts = {s.index: 0 for s in shards}
        errors = {s.index: [] for s in shards}
        remaining = [len(shards)]
        stop = [False]
        stolen = [0]
        retries = [0]
        exec_s = [0.0]

        def worker(w: int) -> None:
            while True:
                with cv:
                    task = None
                    while task is None:
                        if remaining[0] <= 0 or stop[0]:
                            return
                        if deques[w]:
                            task = deques[w].popleft()
                        else:
                            busy = [j for j in range(W)
                                    if j != w and deques[j]]
                            if busy:     # steal the busiest tail
                                j = max(busy, key=lambda j: (
                                    sum(s.cost for s in deques[j]), -j))
                                task = deques[j].pop()
                                stolen[0] += 1
                            else:        # others may still requeue
                                cv.wait(0.02)
                    attempts[task.index] += 1
                    a = attempts[task.index]
                t0 = time.perf_counter()
                try:
                    if fault_hook is not None:
                        fault_hook(task, a, w)
                    res = run_fn(task)
                except WorkerLost as e:
                    with cv:
                        errors[task.index].append(repr(e))
                        retries[0] += 1
                        deques[w].appendleft(task)   # survivors steal it
                        cv.notify_all()
                    return               # this worker is gone
                except Exception as e:   # noqa: BLE001 — bounded retry
                    with cv:
                        errors[task.index].append(repr(e))
                        gone = a > config.max_retries
                        if gone:
                            outcomes[task.index] = Abandoned(
                                task.index, task.digest, a,
                                tuple(errors[task.index]))
                            remaining[0] -= 1
                        else:
                            retries[0] += 1
                        cv.notify_all()
                    if not gone:
                        time.sleep(config.backoff_s * a)
                        with cv:
                            deques[w].append(task)
                            cv.notify_all()
                else:
                    wall = time.perf_counter() - t0
                    with cv:
                        errs = tuple(errors[task.index])
                        out = (Retried(task.index, task.digest, a, w,
                                       wall, errs) if errs else
                               Done(task.index, task.digest, a, w, wall))
                        outcomes[task.index] = out
                        remaining[0] -= 1
                        exec_s[0] += wall
                        cv.notify_all()
                    if on_result(task, res, out) is False:
                        with cv:
                            stop[0] = True
                            cv.notify_all()

        threads = [threading.Thread(target=worker, args=(w,),
                                    name=f"fleet-worker-{w}", daemon=True)
                   for w in range(W)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # every worker died with shards left: abandon them EXPLICITLY
        if not stop[0]:
            with cv:
                for dq in deques:
                    while dq:
                        task = dq.popleft()
                        outcomes[task.index] = Abandoned(
                            task.index, task.digest,
                            attempts[task.index],
                            tuple(errors[task.index])
                            or ("all workers lost",))
                        remaining[0] -= 1
        return outcomes, {"stolen": stolen[0], "retries": retries[0],
                          "exec_s": exec_s[0],
                          "preempted": stop[0]}


# -- multi-process (torch.distributed) --------------------------------------


class DistributedBackend:
    """``torch.distributed`` processes levelling one queue via the journal.

    Every process walks the shard list (own LPT stride first, then
    everyone else's — the claim race IS the work stealing) and runs
    what it can claim; completion is the journal's atomic commit.  The
    coordinator (process 0) then waits for full coverage, reclaiming
    claims older than ``claim_timeout_s`` from dead workers and running
    them locally, so a lost process delays but never drops points.
    Requires a journal (the shared substrate); see
    ``repro_torch.dist.procs`` for process bootstrap.
    """

    name = "distributed"

    def __init__(self, journal: FleetJournal):
        self.journal = journal

    def execute(self, shards, run_fn, on_result, config,
                fault_hook=None):
        from ..dist.procs import process_info
        pid, nproc = process_info()
        me = f"proc{pid}"
        jr = self.journal
        outcomes: dict[int, object] = {}
        stats = {"stolen": 0, "retries": 0, "exec_s": 0.0,
                 "preempted": False}
        order = sorted(shards, key=lambda s: (-s.cost, s.index))
        mine = order[pid::nproc]
        theirs = [s for s in order if s not in mine]

        def attempt(task: ShardSpec, stolen_claim: bool = False) -> bool:
            """Claimed: run to an outcome.  True = stop requested."""
            fails = jr.failures(task.digest)
            a = fails + 1
            if a > config.max_retries + 1:
                outcomes[task.index] = Abandoned(
                    task.index, task.digest, fails,
                    (f"{fails} failures on record",))
                jr.release(task.digest)
                return False
            t0 = time.perf_counter()
            try:
                if fault_hook is not None:
                    fault_hook(task, a, pid)
                res = run_fn(task)
            except Exception as e:   # noqa: BLE001 — bounded retry
                jr.record_failure(task.digest, repr(e))
                jr.release(task.digest)
                stats["retries"] += 1
                time.sleep(config.backoff_s * a)
                return False
            wall = time.perf_counter() - t0
            stats["exec_s"] += wall
            out = (Done(task.index, task.digest, a, pid, wall)
                   if fails == 0 else
                   Retried(task.index, task.digest, a, pid, wall,
                           (f"{fails} prior failures on record",)))
            outcomes[task.index] = out
            stop = on_result(task, res, out) is False
            jr.release(task.digest)
            if stolen_claim:
                stats["stolen"] += 1
            return stop

        stopped = False
        for rounds in range(config.max_retries + 1):
            progressed = False
            for task in mine + theirs:
                if stopped or jr.is_complete(task.digest):
                    continue
                if jr.claim(task.digest, me):
                    stopped = attempt(task, stolen_claim=task in theirs)
                    progressed = True
            if stopped or not progressed:
                break
        stats["preempted"] = stopped

        if pid == 0 and not stopped:
            # coordinator: wait out the stragglers, reclaim the dead
            deadline = time.monotonic() + config.timeout_s
            while time.monotonic() < deadline:
                done = jr.completed()
                left = [s for s in shards if s.digest not in done]
                if not left:
                    break
                for task in left:
                    age = jr.claim_age(task.digest)
                    fails = jr.failures(task.digest)
                    if fails > config.max_retries:
                        continue          # abandoned below
                    if age is None:
                        if jr.claim(task.digest, me):
                            stopped = attempt(task)
                    elif age > config.claim_timeout_s:
                        jr.steal_claim(task.digest, me)
                        stats["stolen"] += 1
                        stopped = attempt(task, stolen_claim=True)
                    if stopped:
                        break
                if stopped:
                    break
                if all(jr.failures(s.digest) > config.max_retries
                       for s in left):
                    break
                time.sleep(config.poll_s)
            done = jr.completed()
            for task in shards:
                if task.index in outcomes or task.digest in done:
                    continue
                fails = jr.failures(task.digest)
                outcomes[task.index] = Abandoned(
                    task.index, task.digest, fails,
                    (f"not completed by any process "
                     f"({fails} failures on record)",))
        return outcomes, stats


# -- coordinator ------------------------------------------------------------


class FleetRunner:
    """Plan in, merged ``SweepResult`` out — resilient in between.

    Resume-skips journaled shards (zero recompute), drives the backend
    over the rest, journals every completion, and merges the per-shard
    results in plan-point order so the output is bitwise the
    uninterrupted one-launch ``Sweep.run()``.
    """

    def __init__(self, plan: FleetPlan,
                 config: FleetConfig | None = None, *,
                 backend: Backend | None = None,
                 journal: "FleetJournal | str | None" = None,
                 fault_hook: FaultHook | None = None):
        self.plan = plan
        self.config = config or FleetConfig()
        if isinstance(journal, str):
            journal = FleetJournal(journal)
        self.journal = journal
        if journal is not None:
            journal.bind(plan)
        if backend is None:
            backend = ThreadBackend(self.config.n_workers)
        if isinstance(backend, DistributedBackend) and journal is None:
            raise ValueError("DistributedBackend needs a journal: it is "
                             "the shared claim/completion substrate")
        self.backend = backend
        self.fault_hook = fault_hook

    def _execute_shard(self, shard: ShardSpec) -> SweepResult:
        sub = self.plan.shard_sweep(shard)
        kw = self.plan.run_kwargs(shard)
        if not self.config.stream:
            return sub.run(**kw)
        spill = (self.journal.spill_dir(shard.digest)
                 if self.journal is not None else None)
        return stream_sweep(
            sub, spill_dir=spill,
            buffer_windows=self.config.buffer_windows, **kw)

    def run(self) -> FleetResult:
        cfg = self.config
        t0 = time.perf_counter()
        misses0 = SWEEP_EXEC_CACHE.stats().misses
        results: dict[int, SweepResult] = {}
        outcomes: dict[int, object] = {}
        stats = FleetStats(n_shards=len(self.plan.shards))

        todo = []
        for s in self.plan.shards:
            if self.journal is not None and \
                    self.journal.is_complete(s.digest):
                results[s.index] = self.journal.load_shard(self.plan, s)
                outcomes[s.index] = Done(s.index, s.digest, 0, -1, 0.0,
                                         resumed=True)
                stats.resumed += 1
            else:
                todo.append(s)

        lock = threading.Lock()
        committed = [stats.resumed]
        preempted = [False]

        def on_result(shard, res, out) -> bool:
            with lock:
                results[shard.index] = res
                if self.journal is not None:
                    spill = (self.journal.spill_dir(shard.digest)
                             if cfg.stream else None)
                    self.journal.save_shard(shard, res, spill=spill)
                committed[0] += 1
                if cfg.preempt_after is not None and \
                        committed[0] >= cfg.preempt_after:
                    preempted[0] = True
                    return False
            return True

        bstats = {}
        if todo:
            got, bstats = self.backend.execute(
                todo, self._execute_shard, on_result, cfg,
                self.fault_hook)
            outcomes.update(got)

        # distributed: shards other processes completed live in the
        # journal only — load them so the coordinator can merge
        if self.journal is not None:
            done = self.journal.completed()
            for s in self.plan.shards:
                if s.index not in results and s.digest in done:
                    results[s.index] = self.journal.load_shard(
                        self.plan, s)
                    if not isinstance(outcomes.get(s.index), Abandoned):
                        outcomes.setdefault(
                            s.index, Done(s.index, s.digest, 1, -1, 0.0))

        stats.executed = sum(
            1 for o in outcomes.values()
            if isinstance(o, (Done, Retried))
            and not getattr(o, "resumed", False) and o.worker >= 0)
        stats.stolen = int(bstats.get("stolen", 0))
        stats.retries = int(bstats.get("retries", 0))
        stats.exec_s = float(bstats.get("exec_s", 0.0))
        stats.abandoned = sum(1 for o in outcomes.values()
                              if isinstance(o, Abandoned))
        stats.compiles = SWEEP_EXEC_CACHE.stats().misses - misses0
        stats.wall_s = time.perf_counter() - t0

        if preempted[0]:
            raise PreemptedError(
                f"fleet preempted after {committed[0]} committed "
                f"shard(s); resume from the journal "
                f"({getattr(self.journal, 'directory', None)})")

        merged = None
        if results:
            have = [s for s in self.plan.shards if s.index in results]
            names = {n for s in have for n in s.names}
            pts = [p for p in self.plan.sweep.points if p.name in names]
            merged = merge_sweepresults(
                [results[s.index] for s in have], points=pts)
        out = FleetResult(result=merged, outcomes=outcomes,
                          stats=stats, plan=self.plan)
        if cfg.strict and stats.abandoned:
            bad = [f"shard {o.shard} {list(o.errors)[-1:]}"
                   for o in out.abandoned]
            raise FleetError(
                f"{stats.abandoned} shard(s) abandoned after bounded "
                f"retries: {'; '.join(bad)}")
        return out


def run_fleet(sweep: Sweep, n_steps: int | None = None,
              trace_every: int | None = None, *,
              config: FleetConfig | None = None,
              backend: Backend | None = None,
              journal: "FleetJournal | str | None" = None,
              fault_hook: FaultHook | None = None,
              plan: FleetPlan | None = None,
              **plan_kw) -> FleetResult:
    """Front door: plan (or take a plan) + schedule + merge.

    ``plan_kw`` forwards to :func:`~repro_torch.fleet.plan.plan_sweep`
    (``reduce``, ``use_kernels``, ``device``, ``min_delay_slots``, …):
    ``device=None`` runs the shards on the card, ``device="cpu"`` on
    the CPU.
    """
    config = config or FleetConfig()
    if plan is None:
        plan = plan_sweep(sweep, n_steps, trace_every,
                          n_shards=config.n_shards,
                          max_points=config.max_points,
                          bucket_by=config.bucket_by, **plan_kw)
    return FleetRunner(plan, config, backend=backend, journal=journal,
                       fault_hook=fault_hook).run()
