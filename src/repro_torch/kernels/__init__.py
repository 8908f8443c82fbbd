"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``cc_step``, ``fluid_reduce``, ``fluid_step``,
``flash_attention``, ``decode_attention``), the attention wrappers the
models call (``ops``), the plain oracles (``ref``) and the ``nvcc``
build step (``build``)."""
