"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

The port mirrors the reference package's layout module for module
(``repro_torch.core.fluid`` ports ``repro.core.fluid``, and so on) and
imports nothing of it, nor JAX.  Entry points (``Sweep.run``,
``simulator.run``) run on the card unless the caller passes
``device="cpu"``; the per-flow CC stages launch the hand-written CUDA
kernels of ``repro_torch.kernels.cc_step`` there.  The decoder-only
transformers serve through ``repro_torch.serve.ServingEngine``
(``configs``, ``models``, ``launch.serve``), with attention in the CUDA
kernels of ``kernels.flash_attention`` / ``kernels.decode_attention``.
``Sweep.run(temperature > 0)`` runs the soft-relaxed model, and
``tune.autotune`` tunes CC constants on it (autograd through the CC and
``segment_reduce`` kernels) and verifies them on the hard model;
``core.serialize`` and ``ckpt`` read and write the reference's formats.
The models train through ``train`` (``optim``, ``data``,
``launch.train``) with the plain attention: the kernels have no
backward and refuse autograd.

    from repro_torch.core import ScenarioSpec, Sweep, CCScheme, PAPER_CONFIG
"""

__all__ = ["core", "net", "kernels", "convert", "configs", "models",
           "serve", "launch", "tune", "ckpt", "optim", "data", "train"]
