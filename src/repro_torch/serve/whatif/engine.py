"""CCQueryEngine — the Sweep as a cache-warm what-if service (port of
``repro.serve.whatif.engine``).

"What if kmin=X on this pod under this incast storm?" as a low-latency
query instead of an offline batch job.  Four layers:

  1. **Executable cache** — every query resolves to the shared
     ``repro_torch.core.SWEEP_EXEC_CACHE`` via its *structural signature*
     (fabric topology / H_MAX / K-paths, bucketed grid shape, trace
     settings, device): the first query on a pod shape pays a build (on
     the card a warm-up window and a CUDA-graph capture), every later
     one copies its data into the captured window's tensors and replays.
  2. **Micro-batcher** — queued queries that share a signature coalesce
     onto the run axis, padded to a fixed batch width
     (``Sweep.run(pad_runs_to=...)``) and a bucketed flow count
     (``pad_scenario``), so batch composition never changes the
     captured program.  Per-query slices are *bitwise* what a
     standalone single-point ``Sweep.run()`` returns (padding is inert
     by construction; gated in tests/test_torch_whatif.py).
  3. **Admission control** — a per-tenant token bucket + bounded queue
     (``repro_torch.serve.whatif.admission``): over-rate submissions get an
     explicit :class:`Throttled`, a full queue gets :class:`QueueFull`;
     nothing blocks forever, nothing queues unboundedly.
  4. **Observability** — per-query latency (p50/p99), batch occupancy,
     cache hit rate and the compile/run time split, as a metrics dict
     (the reference's ``BENCH_serve.json`` records the same dict).

Quickstart::

    from repro_torch.core import CCSpec, ScenarioSpec
    from repro_torch.serve.whatif import (CCQueryEngine, EngineConfig,
                                          WhatIfQuery)

    eng = CCQueryEngine()                       # on the card
    # eng = CCQueryEngine(EngineConfig(device="cpu"))   # on the CPU
    r = eng.ask(WhatIfQuery(cfg=CCSpec(reaction="erp"),
                            scenario=ScenarioSpec.incast(4),
                            n_steps=4000))
    print(r.result.summary(), eng.metrics())

The synchronous surface is unchanged: ``submit`` admits + enqueues,
``drain`` executes everything queued in micro-batches, ``ask`` is
submit-then-drain for one query — that path is bitwise untouched.  Two
opt-in extensions ride on top:

  * ``CCQueryEngine(auto_drain=True)`` runs ``drain`` on a background
    thread woken by ``submit``, so callers enqueue and ``wait(ticket)``
    instead of owning the serve loop.  ``close()`` (or the context
    manager) shuts the thread down cleanly after finishing in-flight
    work; all public methods are thread-safe either way (a batch runs
    through ``Sweep.run``, which holds its cached window, and on the
    card the card's lock, for the run).
  * ``EngineConfig.fleet_threshold`` delegates oversized micro-batches
    (roofline estimate >= the threshold, in seconds, at the H100's
    bandwidth) to ``repro_torch.fleet`` — the batch streams device→host
    in bounded memory instead of holding the whole trace on the card.
    Padding inertness keeps the per-query slices bitwise identical to
    the inline path (``QueryResult.via_fleet`` flags which road a query
    took).

``submit``'s ``_prepare`` is host work (building and padding the
scenario with numpy), so submitters never wait for the card.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Callable

import numpy as np

from ...core import SWEEP_EXEC_CACHE, Sweep, pad_scenario, trim_final
from ...core.experiments import ScenarioSpec
from ...core.fluid import resolve_device
from ...core.params import CCConfig, CCSpec
from ...core.simulator import SimResult, _resolve_steps

from .admission import (AdmissionConfig, AdmissionController, Admitted,
                        QueueFull, Throttled)
from .metrics import EngineMetrics

__all__ = ["CCQueryEngine", "EngineConfig", "QueryResult",
           "StructuralSignature", "WhatIfQuery", "flow_bucket"]


# ---------------------------------------------------------------------------
# queries and results
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WhatIfQuery:
    """One what-if question: a CC config on a workload, for N steps.

    ``scenario`` must be a declarative ``ScenarioSpec`` (the engine
    builds + pads it; raw ``Scenario`` tensors have no stable identity
    to key the executable cache by).  ``tenant`` keys the front-door
    token bucket — the noisy neighbour throttles alone.
    """

    cfg: "CCConfig | CCSpec"
    scenario: ScenarioSpec
    n_steps: int | None = None
    trace_every: int | None = None
    tenant: str = "default"
    label: str = ""

    def __post_init__(self):
        if not isinstance(self.scenario, ScenarioSpec):
            raise TypeError(
                f"WhatIfQuery.scenario must be a ScenarioSpec, got "
                f"{type(self.scenario).__name__}; wrap raw tensors in a "
                f"spec (e.g. ScenarioSpec.flows(pairs, fabric=...))")


@dataclasses.dataclass(frozen=True)
class StructuralSignature:
    """What must match for two queries to share one executable.

    Fabric structure (link/switch/hop-slot counts, K candidate paths),
    the *bucketed* flow count, resolved trace settings and the engine's
    static execution knobs (the reference's ``interpret`` becomes the
    device the engine runs on).  Everything else — CC params, routes,
    rates, timing — is data and swaps freely at run time.
    """

    fabric: str                   # FabricSpec.name (display; also keys
    #   H_MAX/L so distinct families never alias)
    links: int
    hops: int                     # H_MAX of the route table
    paths: int                    # K candidate paths
    switches: int
    flows: int                    # bucketed flow count
    n_samples: int
    trace_every: int
    dt: float
    sim_trace_every: int          # cfg.sim value (Sweep rejects mixes)
    link_key: tuple               # (line_rate, propagation_delay, mtu)
    width: int                    # padded run-axis width
    reduce: str
    dense_rows: int
    use_kernels: "bool | str"
    device: str


def flow_bucket(n_flows: int, minimum: int = 4) -> int:
    """Next power-of-two bucket >= n_flows (floor ``minimum``) — the
    pad-to-bucket that keeps the flow axis off the compile key."""
    b = max(int(minimum), 1)
    while b < n_flows:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine knobs (all part of the structural signature).

    ``dense_rows`` pins the dense-CSR row count so the executable key
    cannot depend on batch *content* (the auto heuristic reads link
    skew); 0 — the default — is the segment-sum path, bit-identical to
    dense.  Operators who know their pod's skew can set it explicitly
    for the dense-tile speedup.

    ``use_kernels`` takes what ``Sweep.run`` takes (False, True,
    ``"mega"``); ``device`` is where batches run: None the card (the
    engine raises at construction without one), ``"cpu"`` by request.
    """

    max_batch: int = 8
    admission: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig)
    reduce: str = "fused"
    use_kernels: "bool | str" = False
    device: object = None
    dense_rows: int = 0
    min_flow_bucket: int = 4
    max_results: int = 1024       # completed results retained for poll
    #: roofline seconds above which a micro-batch is delegated to the
    #: fleet (streamed, bounded host memory); None = always inline.
    fleet_threshold: float | None = None
    fleet_workers: int = 2        # threads for delegated batches

    @property
    def width(self) -> int:
        """Micro-batch width: the run-axis pad target (bounded by
        the admission layer's in-flight cap)."""
        return min(self.max_batch, self.admission.max_inflight)


@dataclasses.dataclass
class QueryResult:
    """One answered what-if query plus its serving telemetry."""

    ticket: int
    label: str
    tenant: str
    result: SimResult             # trimmed to the query's true flows
    latency_s: float              # submit -> answer
    queue_wait_s: float           # submit -> batch launch
    exec_s: float                 # the micro-batch's launch wall time
    batch_size: int               # real queries in the batch
    batch_width: int              # padded run-axis width
    compiled: bool                # this batch paid an executable build
    via_fleet: bool = False       # delegated to repro_torch.fleet

    def to_dict(self, *, traces: bool = False) -> dict:
        """Wire-ready dict: telemetry + headline summary; pass
        ``traces=True`` to inline the full ``SimResult`` payload."""
        out = {"ticket": self.ticket, "label": self.label,
               "tenant": self.tenant,
               "latency_s": round(self.latency_s, 6),
               "queue_wait_s": round(self.queue_wait_s, 6),
               "exec_s": round(self.exec_s, 6),
               "batch_size": self.batch_size,
               "batch_width": self.batch_width,
               "compiled": self.compiled,
               "via_fleet": self.via_fleet,
               "summary": self.result.summary()}
        if traces:
            out["result"] = self.result.to_dict()
        return out


@dataclasses.dataclass
class _Pending:
    ticket: int
    query: WhatIfQuery
    scenario: object              # built (true-F) Scenario
    padded: object                # bucket-padded Scenario
    true_flows: int
    sig: StructuralSignature
    min_delay_slots: int
    t_submit: float


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class CCQueryEngine:
    """Persistent what-if evaluation service over the Sweep machinery.

    See the module docstring for the layer map.  The executable cache
    is the process-wide ``repro_torch.core.SWEEP_EXEC_CACHE`` (shared with
    plain ``Sweep.run`` callers — a sweep warmed offline serves
    queries warm); the engine snapshots its stats at construction so
    ``metrics()`` reports this engine's window only.
    """

    def __init__(self, config: EngineConfig | None = None, *,
                 auto_drain: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        self._clock = clock
        self._admission = AdmissionController(self.config.admission,
                                              clock=clock)
        self._queue: deque[_Pending] = deque()
        self._results: "OrderedDict[int, QueryResult]" = OrderedDict()
        self._metrics = EngineMetrics()
        self._cache_base = SWEEP_EXEC_CACHE.stats()
        self._next_ticket = 0
        self._signatures: set[StructuralSignature] = set()
        # engine state lock (queue/results/metrics) + a condition that
        # signals both "work arrived" (drain loop) and "result landed"
        # (wait); a separate lock serialises drains so a user-called
        # drain() and the background loop never interleave batches.
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._drain_lock = threading.Lock()
        self._closed = False
        self._drainer: threading.Thread | None = None
        self.auto_drain = bool(auto_drain)
        if self.auto_drain:
            self._drainer = threading.Thread(
                target=self._drain_loop, name="whatif-drain", daemon=True)
            self._drainer.start()

    # -- signature ----------------------------------------------------------

    def _prepare(self, query: WhatIfQuery) -> _Pending:
        """Build + bucket-pad the scenario and derive its signature."""
        cfg = query.cfg
        scn = query.scenario.build(cfg)
        F, H = scn.routes.shape
        L = int(scn.capacity.shape[0])
        K = 1 if scn.alt_routes is None else int(scn.alt_routes.shape[1])
        Fb = flow_bucket(F, self.config.min_flow_bucket)
        padded = pad_scenario(scn, Fb, H, L) if Fb > F else scn
        n_samples, k = _resolve_steps(cfg, query.n_steps,
                                      query.trace_every)
        link = cfg.link
        sig = StructuralSignature(
            fabric=query.scenario._fabric().name, links=L, hops=H,
            paths=K, switches=int(scn.n_switches), flows=Fb,
            n_samples=n_samples, trace_every=k, dt=float(cfg.sim.dt),
            sim_trace_every=int(cfg.sim.trace_every),
            link_key=(float(link.line_rate),
                      float(link.propagation_delay), float(link.mtu)),
            width=self.config.width, reduce=self.config.reduce,
            dense_rows=self.config.dense_rows,
            use_kernels=self.config.use_kernels,
            device=str(self.device))
        # delay-line floor from the signature's worst case (a flow
        # using every hop slot), so batch mix can't move the compiled
        # ring depth: matches ScenarioSpec.build's rtt quantisation
        per_hop = link.propagation_delay + link.mtu / link.line_rate
        rtt = 2 * H * per_hop + 1e-6
        d_min = int(max(2, np.round(rtt / cfg.sim.dt))) + 1
        return _Pending(ticket=-1, query=query, scenario=scn,
                        padded=padded, true_flows=F, sig=sig,
                        min_delay_slots=d_min, t_submit=0.0)

    # -- front door ---------------------------------------------------------

    def submit(self, query: WhatIfQuery):
        """Admit + enqueue one query.

        Returns :class:`Admitted` (with the result ticket), or the
        explicit back-pressure outcomes :class:`Throttled` /
        :class:`QueueFull` — the caller decides whether to retry.
        """
        pending = self._prepare(query)      # validates before charging
        with self._lock:
            if self._closed:
                raise RuntimeError("CCQueryEngine is closed")
            outcome = self._admission.admit(query.tenant,
                                            len(self._queue))
            if outcome is not None:
                return outcome
            ticket = self._next_ticket
            self._next_ticket += 1
            pending.ticket = ticket
            pending.t_submit = self._clock()
            self._queue.append(pending)
            self._signatures.add(pending.sig)
            self._wake.notify_all()
            return Admitted(ticket=ticket, tenant=query.tenant,
                            queue_depth=len(self._queue))

    def drain(self) -> list[QueryResult]:
        """Serve the whole queue as signature-grouped micro-batches
        (FIFO: each batch groups the head's signature).  Device
        execution runs outside the state lock, so submitters are never
        blocked behind a batch."""
        done: list[QueryResult] = []
        with self._drain_lock:
            while True:
                with self._lock:
                    if not self._queue:
                        break
                    head_sig = self._queue[0].sig
                    width = self.config.width
                    group: list[_Pending] = []
                    rest: deque[_Pending] = deque()
                    for p in self._queue:
                        if p.sig == head_sig and len(group) < width:
                            group.append(p)
                        else:
                            rest.append(p)
                    self._queue = rest
                batch = self._execute(group, width)
                with self._lock:
                    for qr in batch:
                        self._results[qr.ticket] = qr
                        while len(self._results) > \
                                self.config.max_results:
                            self._results.popitem(last=False)
                    self._wake.notify_all()
                done.extend(batch)
        return done

    def ask(self, query: WhatIfQuery):
        """submit + drain for one query: a ``QueryResult`` if admitted,
        else the ``Throttled`` / ``QueueFull`` outcome.  NOTE: drains
        previously queued queries too (they're answered, retrievable
        via :meth:`result`).  With ``auto_drain`` the background thread
        owns the loop and this waits for the answer instead."""
        outcome = self.submit(query)
        if not isinstance(outcome, Admitted):
            return outcome
        if self.auto_drain:
            return self.wait(outcome.ticket)
        self.drain()
        return self.result(outcome.ticket)

    def result(self, ticket: int) -> QueryResult | None:
        """A completed query's result (None while still queued)."""
        with self._lock:
            return self._results.get(ticket)

    def wait(self, ticket: int,
             timeout: float | None = None) -> QueryResult | None:
        """Block until ``ticket``'s result lands (None on timeout, or
        if the engine closes before serving it)."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        with self._wake:
            while ticket not in self._results:
                if self._closed and self._drainer is None:
                    return self._results.get(ticket)
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0:
                    return None
                self._wake.wait(0.1 if left is None else min(left, 0.1))
            return self._results[ticket]

    # -- background drain / lifecycle ---------------------------------------

    def _drain_loop(self) -> None:
        while True:
            with self._wake:
                while not self._queue and not self._closed:
                    self._wake.wait(0.1)
                if self._closed and not self._queue:
                    return
            self.drain()

    def close(self, *, drain: bool = True) -> None:
        """Shut down cleanly: stop admitting, optionally serve what is
        already queued, and join the background drain thread."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if not drain:
                self._queue.clear()
            self._wake.notify_all()
        th = self._drainer
        if th is not None:
            th.join()
            self._drainer = None
        elif drain:
            self.drain()
        with self._wake:
            self._wake.notify_all()

    def __enter__(self) -> "CCQueryEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- execution ----------------------------------------------------------

    def _execute(self, group: list[_Pending],
                 width: int) -> list[QueryResult]:
        head = group[0]
        q0 = head.query
        t0 = self._clock()
        before = SWEEP_EXEC_CACHE.stats()
        sweep = Sweep([(f"q{p.ticket}", p.query.cfg, p.padded)
                       for p in group])
        kw = dict(n_steps=q0.n_steps, trace_every=q0.trace_every,
                  reduce=self.config.reduce,
                  use_kernels=self.config.use_kernels,
                  device=self.device,
                  min_delay_slots=max(p.min_delay_slots for p in group),
                  dense_rows=self.config.dense_rows)
        via_fleet = self._oversized(group)
        if via_fleet:
            # fleet road: streamed device->host in bounded memory; the
            # per-query slices are bitwise the inline path's (padding
            # is inert; gated in tests/test_torch_whatif.py)
            from ...fleet import FleetConfig, run_fleet
            out = run_fleet(
                sweep,
                config=FleetConfig(n_workers=self.config.fleet_workers,
                                   max_points=max(1, width // 2)),
                **kw)
            res = out.result
        else:
            res = sweep.run(pad_runs_to=width, **kw)
        t1 = self._clock()
        delta = SWEEP_EXEC_CACHE.stats() - before
        exec_s = t1 - t0
        out = []
        with self._lock:
            self._metrics.record_batch(len(group), width, exec_s)
            for p in group:
                sim = self._trim(res[f"q{p.ticket}"], p)
                latency = t1 - p.t_submit
                wait = t0 - p.t_submit
                self._metrics.latency.record(latency)
                self._metrics.queue_wait.record(wait)
                out.append(QueryResult(
                    ticket=p.ticket, label=p.query.label or q0.label,
                    tenant=p.query.tenant, result=sim,
                    latency_s=latency, queue_wait_s=wait, exec_s=exec_s,
                    batch_size=len(group), batch_width=width,
                    compiled=delta.misses > 0, via_fleet=via_fleet))
        return out

    def _oversized(self, group: list[_Pending]) -> bool:
        """Roofline estimate of the batch vs ``fleet_threshold``."""
        thr = self.config.fleet_threshold
        if thr is None:
            return False
        from ...fleet.plan import estimate_point_cost
        sig = group[0].sig
        steps = sig.n_samples * sig.trace_every
        est = sum(estimate_point_cost(p.padded, steps) for p in group)
        return est >= thr

    @staticmethod
    def _trim(sim: SimResult, p: _Pending) -> SimResult:
        """Bucket-padded point view -> the query's true flow count."""
        F = p.true_flows
        if sim.delivered.shape[1] == F:
            return dataclasses.replace(sim, scn=p.scenario)
        return dataclasses.replace(
            sim, scn=p.scenario,
            delivered=sim.delivered[:, :F], rate=sim.rate[:, :F],
            inst_thr=sim.inst_thr[:, :F], marked=sim.marked[:, :F],
            cnp=sim.cnp[:, :F], ctrl=sim.ctrl[:, :F],
            final=trim_final(sim.final, F))

    # -- observability ------------------------------------------------------

    def metrics(self) -> dict:
        """The serving metrics dict: query/batch counters, latency
        percentiles, batch occupancy, executable-cache hit rate and the
        compile/run split — everything the reference's
        ``BENCH_serve.json`` records."""
        with self._lock:
            out = self._metrics.to_dict(
                cache_stats=SWEEP_EXEC_CACHE.stats() - self._cache_base,
                admission=self._admission.counters())
            out["queue_depth"] = len(self._queue)
            out["signatures"] = len(self._signatures)
        out["batch_width"] = self.config.width
        return out
