"""Loss and gradients of the smoke configs with a mixer of their own
(RG-LRU, SSM, both MoE dispatches) through ``repro_torch.train.step.
model_loss``, against the reference's ``jax.value_and_grad`` on the CPU
(``_torch_families.loss_and_grads_match``: losses within 1e-5, each
gradient leaf within 5e-4 of its scale).  The dense configs are in
``test_torch_train_dense.py``, the encoder-decoder and the VLM in
``test_torch_train_encdec_vlm.py``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_families import loss_and_grads_match            # noqa: E402


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "falcon-mamba-7b",
                                  "mixtral-8x22b", "deepseek-moe-16b"])
def test_loss_and_grads_match_reference(arch):
    aux = loss_and_grads_match(arch)
    # the MoE routers' load-balancing loss takes part
    assert (aux > 0) == (arch in ("mixtral-8x22b", "deepseek-moe-16b"))
