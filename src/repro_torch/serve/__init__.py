"""repro_torch.serve — serving layers (port of ``repro.serve``).

  * engine: batched KV-cache token serving (continuous batching)
  * whatif: the what-if CC query service (``repro_torch.serve.whatif``)
"""

from .engine import ServeConfig, ServingEngine

__all__ = ["ServeConfig", "ServingEngine"]
