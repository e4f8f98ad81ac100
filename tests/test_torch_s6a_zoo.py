"""``fl/zoo.ZooModel`` against the reference's, on the CPU, in fp32 (shared
builders in ``tests/_torch_s6a.py``): for the dense decoder-only zoo
configs' SMOKE variants (gemma-2b, h2o-danube-1.8b, granite-20b,
minitron-8b), the loss (the full-sequence LM loss over ``concat(x, y)``)
and its gradient against ``jax.value_and_grad`` of the reference's
``ZooModel.loss``, from the reference's own params carried over with
``convert.zoo_params_from_jax``; ``l2`` and client-batched grads; the
last-position logits and the accuracy; the refusal of the enc-dec and
cross-attention configs.  The MoE configs are in
``test_torch_s6a_zoo_moe.py``, the Mamba ones in
``test_torch_s6a_zoo_ssm.py``.

Tolerances (fp32, two frameworks): the loss to rtol 1e-5; each gradient
leaf to ``atol = 1e-4 * max |grad|`` of that leaf (plus rtol 1e-3), the
difference of two reduction orders over a few thousand terms; the logits
to rtol 1e-4, atol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_s6a import (B, as_tokens, check_loss_and_grad, close_grads,
                        one_torch_thread, setup)  # noqa: F401
from repro.fl import zoo as jzoo
from repro_torch.fl import ZooModel, zoo_model


@pytest.mark.parametrize("arch", ["gemma-2b", "h2o-danube-1.8b",
                                  "granite-20b", "minitron-8b"])
def test_loss_and_grad_match_the_reference(arch):
    check_loss_and_grad(arch)


def test_l2_is_honoured_and_grads_batch_over_clients():
    """l2 adds 0.5 * l2 * Σ‖p‖² as the reference does; two clients'
    batched grads are each client's own."""
    jm, tm, jp, tp, x, y = setup("h2o-danube-1.8b")
    l2 = 0.01
    jloss, jgrad = jax.value_and_grad(lambda p: jm.loss(p, x, y, l2))(jp)
    np.testing.assert_allclose(
        tm.loss(tp, as_tokens(x), as_tokens(y), l2).item(), float(jloss),
        rtol=1e-5)
    x2, y2 = x[::-1].copy(), y[::-1].copy()
    two = {k: torch.stack([v, 2 * v]) for k, v in tp.items()}
    grads = tm.grad(two, (torch.stack([as_tokens(x), as_tokens(x2)]),
                          torch.stack([as_tokens(y), as_tokens(y2)])), l2)
    close_grads({k: g[0] for k, g in grads.items()}, jax.tree.leaves(jgrad))
    one = tm.grad({k: v[1:] for k, v in two.items()},
                  (as_tokens(x2)[None], as_tokens(y2)[None]), l2)
    for k in grads:
        assert torch.equal(grads[k][1], one[k][0]), k


def test_apply_and_accuracy_match_the_reference():
    """Last-position fp32 logits over the vocab; float token ids (as the
    enclave unseals them) round back to the same ids; top-1 accuracy in
    batches."""
    jm, tm, jp, tp, x, y = setup("gemma-2b")
    want = np.asarray(jm.apply(jp, x))
    got = tm.apply(tp, as_tokens(x))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (B, tm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(tm.apply(tp, as_tokens(x).float()), got)
    yy = np.asarray(want.argmax(-1))
    yy[0] = (yy[0] + 1) % tm.cfg.vocab_size
    assert tm.accuracy(tp, as_tokens(x), torch.from_numpy(yy).long(),
                       batch=1) == jm.accuracy(jp, x, yy, batch=1) == 0.5


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-90b"])
def test_zoo_model_refuses_encoder_and_cross_configs(arch):
    with pytest.raises(ValueError) as want:
        jzoo.zoo_model(arch)
    with pytest.raises(ValueError) as got:
        zoo_model(arch)
    assert str(got.value) == str(want.value)


def test_zoo_model_contract():
    """The SmallModel contract as the reference's ZooModel states it; the
    flat params sort in leaf order and rebuild the tree as the same
    tensors."""
    m = zoo_model("h2o-danube-1.8b", seq_len=7)
    j = jzoo.zoo_model("h2o-danube-1.8b", seq_len=7)
    assert isinstance(m, ZooModel) and m.name == j.name
    assert m.input_shape == j.input_shape == (7,)
    assert m.n_classes == j.n_classes
    assert m.param_count() == j.param_count()
    p = m.init(torch.Generator().manual_seed(0), "cpu")
    assert sum(v.numel() for v in p.values()) == m.param_count()
    assert list(p) == sorted(p)
    assert m.tree(p)["embed"] is p[next(iter(p))]
