"""Observability for the what-if engine: latency, occupancy, cache
(port of ``repro.serve.whatif.metrics``: pure Python, the reference's
code).

Everything here is plain-python accumulation — no numpy in the hot
path, dicts of scalars out — because the metrics are part of the wire
surface: the reference's ``BENCH_serve.json`` records the same dict, and
``chip_smoke.py`` prints the port's.  In the port a cache "compile" is a
build of a sweep window: on the card a warm-up window and a CUDA-graph
capture.
"""

from __future__ import annotations

import dataclasses


class LatencyRecorder:
    """Per-query latency samples with percentile summaries.

    Keeps every sample (queries are seconds apart and kilobyte-sized;
    a replay of 10^5 queries is still only megabytes) so p50/p99 are
    exact, not sketched.
    """

    def __init__(self, name: str = "latency"):
        self.name = name
        self._samples: list[float] = []

    def record(self, seconds: float) -> None:
        self._samples.append(float(seconds))

    def __len__(self) -> int:
        return len(self._samples)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, q in [0, 100]; nan when empty."""
        if not self._samples:
            return float("nan")
        s = sorted(self._samples)
        rank = max(0, min(len(s) - 1,
                          int(round(q / 100.0 * (len(s) - 1)))))
        return s[rank]

    def summary(self) -> dict:
        if not self._samples:
            return {"count": 0}
        return {"count": len(self._samples),
                "mean": sum(self._samples) / len(self._samples),
                "p50": self.percentile(50.0),
                "p99": self.percentile(99.0),
                "max": max(self._samples)}


@dataclasses.dataclass
class EngineMetrics:
    """Counters + recorders the engine updates as it serves.

    ``compile_s`` vs ``run_s`` is the compile-time / run-time split:
    compile seconds come from the executable cache's build clock (a
    miss pays one build — on the card a warm-up window and a CUDA-graph
    capture — exactly once), run seconds are the wall time of each
    micro-batch.
    """

    queries: int = 0              # completed queries
    batches: int = 0              # micro-batches launched
    occupancy_sum: float = 0.0    # sum over batches of real/width
    run_s: float = 0.0            # device launch + host pack/slice time
    latency: LatencyRecorder = dataclasses.field(
        default_factory=LatencyRecorder)
    queue_wait: LatencyRecorder = dataclasses.field(
        default_factory=lambda: LatencyRecorder("queue_wait"))

    def record_batch(self, n_real: int, width: int,
                     exec_s: float) -> None:
        self.batches += 1
        self.queries += n_real
        self.occupancy_sum += n_real / max(1, width)
        self.run_s += exec_s

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.batches if self.batches else 0.0

    def to_dict(self, cache_stats=None, admission=None) -> dict:
        """The metrics dict of the serving layer (wire-ready scalars).

        ``cache_stats``: a ``CacheStats`` *window delta* for the
        executable cache; ``admission``: the controller's counters.
        """
        out = {
            "queries": self.queries,
            "batches": self.batches,
            "mean_occupancy": round(self.mean_occupancy, 4),
            "run_s": round(self.run_s, 4),
            "latency_s": {k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in self.latency.summary().items()},
            "queue_wait_s": {k: (round(v, 6) if isinstance(v, float)
                                 else v)
                             for k, v in self.queue_wait.summary().items()},
        }
        if cache_stats is not None:
            out["exec_cache"] = cache_stats.to_dict()
            out["compile_s"] = round(cache_stats.build_s, 3)
        if admission is not None:
            out["admission"] = dict(admission)
        return out
