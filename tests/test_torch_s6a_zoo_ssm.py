"""``fl/zoo.ZooModel`` against the reference's for the zoo configs with
Mamba layers' SMOKE variants (jamba-v0.1-52b with its MoE layers,
falcon-mamba-7b), on the CPU, in fp32: the loss and its gradient against
``jax.value_and_grad`` of the reference's ``ZooModel.loss`` (tolerances as
in ``test_torch_s6a_zoo.py``)."""
import pytest

from _torch_s6a import check_loss_and_grad, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "falcon-mamba-7b"])
def test_loss_and_grad_match_the_reference(arch):
    check_loss_and_grad(arch)
