"""Shared builders of the zoo-model tests (``tests/test_torch_s6a_zoo*.py``):
each SMOKE config in fp32 in both packages, the reference's params carried
over with ``convert.zoo_params_from_jax``, tokens from numpy, and the
gradient comparison."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.fl import zoo as jzoo
from repro_torch import configs
from repro_torch.convert import zoo_params_from_jax
from repro_torch.fl import zoo_model

B, S = 2, 12


def pair(arch, **kw):
    kw = dict(dtype="float32", param_dtype="float32", **kw)
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), **kw)
    cfg = dataclasses.replace(configs.get(arch, smoke=True), **kw)
    return jzoo.zoo_model(jcfg, seq_len=S), zoo_model(cfg, seq_len=S)


def setup(arch, seed=0, **kw):
    jm, tm = pair(arch, **kw)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = zoo_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed + 1)
    x = rng.integers(0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    y = rng.integers(0, tm.cfg.vocab_size, (B,)).astype(np.int32)
    return jm, tm, jp, tp, x, y


def as_tokens(a):
    return torch.from_numpy(a).long()


def close_grads(got, want):
    """Each leaf to ``atol = 1e-4 * max |grad|`` of the leaf, rtol 1e-3."""
    assert len(got) == len(want)
    for (k, g), w in zip(got.items(), want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, k
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-12, err_msg=k)


def check_loss_and_grad(arch):
    """The loss and the client-batched grad against
    ``jax.value_and_grad`` of the reference's ``ZooModel.loss``."""
    jm, tm, jp, tp, x, y = setup(arch)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jm.loss(p, x, y, 0.0))(jp)
    loss = tm.loss(tp, as_tokens(x), as_tokens(y))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = tm.grad({k: v[None] for k, v in tp.items()},
                    (as_tokens(x)[None], as_tokens(y)[None]))
    assert list(grads) == list(tp)
    assert all(g.shape[0] == 1 for g in grads.values())
    close_grads({k: g[0] for k, g in grads.items()},
                jax.tree.leaves(jgrad))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
