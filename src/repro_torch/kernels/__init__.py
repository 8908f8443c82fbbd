"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``cc_step``, ``fluid_reduce``, ``fluid_step``,
``flash_attention``, ``decode_attention``), the wrappers that dispatch
by device (``ops``), the plain oracles (``ref``), the ``nvcc`` build
step (``build``) and the megakernel's per-phase table on the card
(``phase_probe``).

The package binds what ``repro.kernels`` binds: the functions
``flash_attention``, ``decode_attention``, ``rp_step``, ``erp_step``,
``megastep`` and ``megastep_block`` and the modules ``ops`` and ``ref``.
So ``repro_torch.kernels.flash_attention`` is the function; take the
module (its ``LAUNCHES``, ``ROUTES``, plain version) with
``from repro_torch.kernels.flash_attention import ...`` or
``importlib.import_module``.
"""

from . import ops, ref
from .flash_attention import flash_attention
from .decode_attention import decode_attention
from .cc_step import erp_step, rp_step
from .fluid_step import megastep, megastep_block

__all__ = ["ops", "ref", "flash_attention", "decode_attention",
           "erp_step", "rp_step", "megastep", "megastep_block"]
