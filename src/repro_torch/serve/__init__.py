"""repro_torch.serve — serving layers (port of ``repro.serve``).

  * engine: batched KV-cache token serving (continuous batching)

The what-if CC query service (``repro.serve.whatif``) is not ported yet.
"""

from .engine import ServeConfig, ServingEngine

__all__ = ["ServeConfig", "ServingEngine"]
