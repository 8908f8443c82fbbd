"""repro_torch.serve.whatif — the simulator as a throttled, cache-warm
what-if query service (port of ``repro.serve.whatif``).

  * engine:    CCQueryEngine / WhatIfQuery / QueryResult — micro-
               batched queries over the Sweep, keyed to the shared
               sweep cache (one captured CUDA graph a batch structure)
  * admission: token-bucket + bounded-queue front door with explicit
               Admitted / Throttled / QueueFull outcomes
  * metrics:   latency percentiles, batch occupancy, cache hit rate,
               build/run split
"""

from .admission import (AdmissionConfig, AdmissionController, Admitted,
                        QueueFull, Throttled, TokenBucket)
from .engine import (CCQueryEngine, EngineConfig, QueryResult,
                     StructuralSignature, WhatIfQuery, flow_bucket)
from .metrics import EngineMetrics, LatencyRecorder

__all__ = [
    "AdmissionConfig", "AdmissionController", "Admitted", "QueueFull",
    "Throttled", "TokenBucket",
    "CCQueryEngine", "EngineConfig", "QueryResult",
    "StructuralSignature", "WhatIfQuery", "flow_bucket",
    "EngineMetrics", "LatencyRecorder",
]
