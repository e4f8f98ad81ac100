"""``fl/zoo.ZooModel`` against the reference's for the MoE zoo configs'
SMOKE variants (deepseek-moe-16b, kimi-k2-1t-a32b), on the CPU, in fp32:
the loss with the MoE layers' load-balance aux term, and its gradient,
against ``jax.value_and_grad`` of the reference's ``ZooModel.loss``
(tolerances as in ``test_torch_s6a_zoo.py``)."""
import numpy as np
import pytest

from _torch_s6a import (as_tokens, check_loss_and_grad, one_torch_thread,
                        setup)  # noqa: F401
from repro import models as jmodels
from repro_torch import models


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
def test_loss_and_grad_match_the_reference(arch):
    check_loss_and_grad(arch)


def test_moe_aux_term_is_in_the_loss():
    """deepseek-moe's SMOKE loss is the LM loss plus a nonzero aux term,
    each as the reference computes it."""
    jm, tm, jp, tp, x, y = setup("deepseek-moe-16b")
    tok = np.concatenate([x, y[:, None]], 1)
    jaux = float(jmodels.apply(jp, jm.cfg, tok)["aux"])
    aux = models.apply(tm.tree(tp), tm.cfg, as_tokens(tok))["aux"].item()
    assert jaux > 0
    np.testing.assert_allclose(aux, jaux, rtol=1e-5)
    np.testing.assert_allclose(
        tm.loss(tp, as_tokens(x), as_tokens(y)).item() - aux,
        float(jm.loss(jp, x, y)) - jaux, rtol=1e-5)
