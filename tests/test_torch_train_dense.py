"""Loss and gradients of the dense decoder-only smoke configs (GQA with
and without biases, gemma2's local/global layers and softcaps, phi3)
through ``repro_torch.train.step.model_loss``, against the reference's
``jax.value_and_grad`` on the CPU (``_torch_families.
loss_and_grads_match``: losses within 1e-5, each gradient leaf within
5e-4 of its scale)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_families import loss_and_grads_match            # noqa: E402


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "starcoder2-3b",
                                  "gemma2-27b", "phi3-medium-14b"])
def test_loss_and_grads_match_reference(arch):
    assert loss_and_grads_match(arch) == 0.0
