"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``cc_step``), and the ``nvcc`` builder (``build``)."""
