"""Loss and gradients of whisper-base's and internvl2-26b's smoke configs
(stub frames; stub patches whose positions' labels are -1) through
``repro_torch.train.step.model_loss``, against the reference's
``jax.value_and_grad`` on the CPU (``_torch_families.
loss_and_grads_match``: losses within 1e-5, each gradient leaf within
5e-4 of its scale; whisper-base's, whose reference gradient is itself
2e-3 from the float64 one, within 3e-3, ``GRAD_REL``)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from _torch_families import loss_and_grads_match            # noqa: E402


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-26b"])
def test_loss_and_grads_match_reference(arch):
    assert loss_and_grads_match(arch) == 0.0
