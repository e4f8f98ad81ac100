"""The port's neural-network models, data and metrics against the JAX
reference, on the CPU.

Params come from the reference's ``init`` through
``convert.params_from_jax``: the port keeps the reference's HWIO
convolution weights and NHWC images, so they carry over unchanged.
Inputs are made with numpy from a seed.  Tolerance is fp32: rtol 1e-4,
atol 1e-5 for values, and gradients are compared against the largest
entry of their leaf (``_grad_close``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attacks import AttackConfig as JaxAttackConfig
from repro.core.tee import Enclave as JaxEnclave
from repro.data import partition_dirichlet as jax_dirichlet
from repro.data import partition_two_shards as jax_two_shards
from repro.fl import metrics as jax_metrics
from repro.fl import small_models as jax_models
from repro_torch.convert import params_from_jax
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.tee import Enclave
from repro_torch.data import (make_cifar_like, partition_dirichlet,
                              partition_two_shards)
from repro_torch.fl import metrics
from repro_torch.fl import small_models as models

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _grad_close(got, want):
    """Gradient leaves agree to 1e-4 of the leaf's largest entry: the
    two frameworks sum a convolution's or matmul's products in different
    orders."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale)


MODELS = {
    "mlp3": (lambda m: m.mlp3(hidden=16), (28, 28)),
    "small_cnn": (lambda m: m.small_cnn(), (32, 32, 3)),
    "vgg11": (lambda m: m.vgg11(), (32, 32, 3)),
}


def _pair(name, seed=1):
    make, shape = MODELS[name]
    jm, tm = make(jax_models), make(models)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu")
    return jm, tm, jp, tp, shape


def _images(shape, n, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (n,) + shape).astype(np.float32)
    y = rng.integers(0, 10, size=lead + (n,)).astype(np.int32)
    return x, y


# ----------------------------------------------------------------------
# models
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_model_loss_and_grad_match_the_reference(name):
    """Logits, loss and the gradient of every leaf, at 2 images for
    VGG-11 (its only width; it has 28.1M parameters) and 6 for the rest.
    The loss is compared without the l2 term: the reference sums ‖p‖²
    with ``jnp.vdot`` in fp32, which over VGG-11's 16.7M-entry layer
    loses about 0.7 % of the sum on XLA:CPU.  The gradients carry l2
    (its gradient, l2·p, has no such sum)."""
    jm, tm, jp, tp, shape = _pair(name)
    x, y = _images(shape, 2 if name == "vgg11" else 6)
    _close(tm.apply(tp, _t(x)), jm.apply(jp, jnp.asarray(x)))
    _close(tm.loss(tp, _t(x), _t(y).long()),
           jm.loss(jp, jnp.asarray(x), jnp.asarray(y)))
    jg = jax.grad(lambda p: jm.loss(p, jnp.asarray(x), jnp.asarray(y),
                                    0.0005))(jp)
    tg = tm.grad(tp, (_t(x), _t(y).long()), 0.0005)
    assert set(tg) == set(jg)
    for k in jg:
        assert tg[k].shape == jg[k].shape, k
        _grad_close(tg[k], jg[k])


@pytest.mark.parametrize("name", ["mlp3", "small_cnn"])
def test_client_batched_grad_is_the_per_client_grad(name):
    """Three clients with their own params and batches in one grouped
    pass give each client's own gradient."""
    _, tm, _, tp, shape = _pair(name)
    x, y = _images(shape, 4, seed=2, lead=(3,))
    batched = {k: torch.stack([v, 0.5 * v, -v]) for k, v in tp.items()}
    g = tm.grad(batched, (_t(x), _t(y).long()), 0.0005)
    losses = tm.loss(batched, _t(x), _t(y).long(), 0.0005)
    for c in range(3):
        one = {k: v[c] for k, v in batched.items()}
        gc = tm.grad(one, (_t(x[c]), _t(y[c]).long()), 0.0005)
        _close(losses[c], tm.loss(one, _t(x[c]), _t(y[c]).long(), 0.0005))
        for k in gc:
            _close(g[k][c], gc[k], rtol=1e-5, atol=1e-6)


def test_model_init_shapes_match_the_reference():
    for name in MODELS:
        make, _ = MODELS[name]
        jp = make(jax_models).init(jax.random.PRNGKey(0))
        tp = make(models).init(torch.Generator().manual_seed(0), "cpu")
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}, name
    n = sum(v.numel() for v in models.vgg11().init(
        torch.Generator().manual_seed(0), "cpu").values())
    assert n == 28_146_762


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------

def _labelled(n=460, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("seed", [0, 3])
def test_two_shard_partition_is_exactly_the_reference(seed):
    x, y = _labelled()
    got = partition_two_shards(_t(x), _t(y), 23, seed=seed)
    want = jax_two_shards(x, y, 23, seed=seed)
    assert len(got) == len(want) == 23
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


@pytest.mark.parametrize("alpha,seed", [(0.3, 0), (5.0, 2)])
def test_dirichlet_partition_is_exactly_the_reference(alpha, seed):
    x, y = _labelled()
    got = partition_dirichlet(_t(x), _t(y), 7, alpha=alpha, seed=seed)
    want = jax_dirichlet(x, y, 7, alpha=alpha, seed=seed)
    assert sum(len(p[1]) for p in got) == len(y)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


def test_make_cifar_like_shapes_and_class_structure():
    x, y = make_cifar_like(torch.Generator().manual_seed(0), 200)
    assert x.shape == (200, 32, 32, 3) and x.dtype == torch.float32
    assert y.shape == (200,) and int(y.min()) >= 0 and int(y.max()) <= 9
    x2, y2 = make_cifar_like(torch.Generator().manual_seed(1), 200)
    means = [x[y == c].mean(0).flatten() for c in (0, 1)]
    means2 = [x2[y2 == c].mean(0).flatten() for c in (0, 1)]
    corr = torch.corrcoef(torch.stack(means + means2))
    assert corr[0, 2] > 0.9 and corr[1, 3] > 0.9     # shared templates
    assert abs(float(corr[0, 1])) < 0.3              # distinct classes


# ----------------------------------------------------------------------
# metrics and the enclave's capacity model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("flat", [False, True])
def test_backdoor_metrics_match_the_reference(flat):
    jm, tm, jp, tp, _ = _pair("mlp3", seed=4)
    x, y = _images((28, 28), 120, seed=5)
    y[:40] = 3
    if flat:                    # flat inputs: the first 3 features stamped
        x = x.reshape(120, 784)
    jcfg = JaxAttackConfig(kind="backdoor", source_class=3, target_class=4)
    tcfg = AttackConfig(kind="backdoor", source_class=3, target_class=4)
    np.testing.assert_array_equal(metrics.stamp_trigger(_t(x)).numpy(),
                                  np.asarray(jax_metrics.stamp_trigger(
                                      jnp.asarray(x))))
    ev = metrics.make_backdoor_eval(_t(x), _t(y), tcfg)
    jev = jax_metrics.make_backdoor_eval(jnp.asarray(x), jnp.asarray(y), jcfg)
    np.testing.assert_array_equal(ev.src.numpy(), np.asarray(jev.src))
    pairs = [
        (metrics.backdoor_accuracy_on(tm, tp, ev),
         jax_metrics.backdoor_accuracy_on(jm, jp, jev)),
        (metrics.backdoor_accuracy(tm, tp, _t(x), _t(y), tcfg),
         jax_metrics.backdoor_accuracy(jm, jp, jnp.asarray(x),
                                       jnp.asarray(y), jcfg)),
        (metrics.main_task_accuracy(tm, tp, _t(x), _t(y), tcfg),
         jax_metrics.main_task_accuracy(jm, jp, jnp.asarray(x),
                                        jnp.asarray(y), jcfg)),
        (metrics.masked_accuracy(tm, tp, _t(x), _t(y), _t(y > 5)),
         jax_metrics.masked_accuracy(jm, jp, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(y > 5))),
        (metrics.masked_accuracy(tm, tp, _t(x), _t(y), torch.zeros(120)),
         jax_metrics.masked_accuracy(jm, jp, jnp.asarray(x), jnp.asarray(y),
                                     jnp.zeros(120))),
    ]
    for got, want in pairs:
        assert float(got) == float(want)


@pytest.mark.parametrize("flops,step,model_bytes", [
    (1e9, 0.5, 0), (2e9, 1.0, 200 * 2 ** 20), (0.0, 1.0, 0),
    (1e12, 0.01, 0)])
def test_enclave_max_clients_matches_the_reference(flops, step, model_bytes):
    assert Enclave.max_clients(flops, step, model_bytes=model_bytes) == \
        JaxEnclave.max_clients(flops, step, model_bytes=model_bytes)
