"""The RG-LRU, SSM and MoE families' trunks against the reference's, on
the CPU: the recurrentgemma, falcon-mamba, deepseek-moe and mixtral
smoke configs in float32, with the reference's weights carried across
by ``convert.params_from_numpy``.  Prefill logits and caches (KV caches,
``SSMState``s, ``RGLRUState``s), then 8 ``decode_step``s past the window
of 16, through the plain attention path and through ``use_pallas``
(the kernels' plain versions on the CPU); greedy tokens equal at every
step (their ``forward`` is held in ``tests/test_torch_transformer.py``).
Bound: 1e-4 relative to each tensor's largest magnitude, as for
gemma2 (``tests/test_torch_transformer.py``); recurrentgemma is held
against the reference's unrolled layers (``_torch_families.UNROLLED``
says why).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_families import FAMILIES, prefill_and_decode_match  # noqa

#: (arch, use_pallas): falcon-mamba has no attention, so one path
PATHS = [(a, p) for a in FAMILIES for p in (False, True)
         if not (a == "falcon-mamba-7b" and p)]


@pytest.mark.parametrize("arch,use_pallas", PATHS)
def test_prefill_and_decode_match_reference(arch, use_pallas):
    prefill_and_decode_match(arch, use_pallas)
