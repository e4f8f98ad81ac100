"""Slice 8 on the CPU: RSA, the sample-poisoning screen, SGD and the
schedules, the dict-params forms of DiverseFL's statistics and Eq. 6, the
tree attack and the batch iterator, each against the JAX reference with
the reference's draws injected; and a census that every public name of
the reference's core, data, optim, RSA and small-model modules (and,
since later slices, its engine, fault, telemetry and sweep modules, the
zoo's attention, MoE, frontend and model modules and the serving module)
has its counterpart in the port or a named exclusion."""
import ast
import dataclasses
import importlib
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jax_attacks
from repro.core import diversefl as jax_dfl
from repro.core import sample_filter as jax_filter
from repro.core.tee import Enclave as JaxEnclave
from repro.data import FederatedData as JaxFederatedData
from repro.data import batch_iterator as jax_batch_iterator
from repro.data import partition_sorted_shards as jax_partition
from repro.fl import FLConfig as JaxFLConfig
from repro.fl import Federation as JaxFederation
from repro.fl.engine import make_round_body as jax_make_round_body
from repro.fl.rsa import run_rsa as jax_run_rsa
from repro.fl.small_models import mlp3 as jax_mlp3
from repro.fl.small_models import softmax_regression as jax_softmax
from repro import optim as jax_optim
from repro_torch.convert import params_from_jax
from repro_torch.core import (DiverseFLConfig, diversefl_aggregate,
                              masked_mean, similarity_stats,
                              similarity_stats_tree)
from repro_torch.core.attacks import AttackConfig, attack_update_tree
from repro_torch.core.sample_filter import (FilterConfig,
                                            pretrain_clean_model,
                                            screen_clients)
from repro_torch.core.tee import Enclave
from repro_torch.data import (ClientDataset, FederatedData, batch_iterator,
                              partition_sorted_shards)
from repro_torch.fl import (FLConfig, Federation, make_round_body, mlp3,
                            softmax_regression)
from repro_torch.fl.rsa import run_rsa
from repro_torch import optim
from test_torch_slice import _numpy_mnist_like, jax_guide_shim  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_CLIENTS, F = 23, 5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------
# RSA
# ----------------------------------------------------------------------

def _rsa_draws(seed, rounds, n, m, per_client, shapes):
    """The reference's draws, rebuilt from its key chain: each round
    ``split(key)`` -> ``split(sub)`` -> ``kb, ka``; the minibatch is one
    ``randint`` per client key of ``split(kb, N)``; the gaussian copies
    are ``normal(ka, shape)`` for every leaf, the same ``ka`` each."""
    key = jax.random.PRNGKey(seed)
    idx, noise = [], []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        kb, ka = jax.random.split(sub)
        keys = jax.random.split(kb, n)
        idx.append(np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (m,), 0, per_client))(keys)))
        noise.append({k: _t(jax.random.normal(ka, s))
                      for k, s in shapes.items()})
    return torch.from_numpy(np.stack(idx)).long(), noise


def _capturing(model, log):
    """``model`` whose ``accuracy`` also records the params it scores: RSA
    scores theta_M at every eval, so with ``eval_every=1`` the log is the
    master's trajectory, in either package."""
    class Capture(type(model)):
        def accuracy(self, params, *a, **k):
            log.append({n: np.array(v) for n, v in params.items()})
            return super().accuracy(params, *a, **k)
    return Capture(**{f.name: getattr(model, f.name)
                      for f in dataclasses.fields(model)})


@pytest.mark.parametrize("attack", ["none", "gaussian", "sign_flip",
                                    "same_value", "label_flip"])
def test_rsa_matches_the_reference(attack):
    """10 RSA rounds at the defaults (delta 0.25, l2 0.0067) from the
    reference's draws, theta_M compared after every round: the same
    accuracies, and theta_M within rtol 1e-4 / atol 1e-5, boundary-aware.
    sign() turns a rounding difference at a near-tie (|t - theta_M| within
    an ulp) into a whole step of lr * delta, so a coordinate may leave the
    tolerance only by such steps, k >= 1 of them at the round it first
    leaves, and at most 0.1 % of the coordinates may."""
    x, y = _numpy_mnist_like(1150, seed=0)
    tx, ty = _numpy_mnist_like(300, seed=9)
    rounds, m, delta = 10, 50, 0.25
    acfg = dict(kind=attack, sigma=1e4)
    jcfg = JaxFLConfig(n_clients=N_CLIENTS, f=F, rounds=rounds,
                       aggregator="mean",
                       attack=jax_attacks.AttackConfig(**acfg),
                       batch_size=m, eval_every=1)
    jlog, log = [], []
    jmodel = _capturing(jax_softmax(), jlog)
    jdata = JaxFederatedData.from_partitions(
        jax_partition(x, y, N_CLIENTS), 10)
    jfed = JaxFederation.create(jmodel, jdata, jnp.asarray(tx),
                                jnp.asarray(ty), jcfg, jax.random.PRNGKey(2))
    jh = jax_run_rsa(jmodel, jfed, jcfg, jax_optim.inv_sqrt_lr(0.02))

    cfg = FLConfig(n_clients=N_CLIENTS, f=F, rounds=rounds, aggregator="mean",
                   attack=AttackConfig(**acfg), batch_size=m, eval_every=1)
    model = _capturing(softmax_regression(), log)
    data = FederatedData.from_partitions(
        partition_sorted_shards(_t(x), _t(y).long(), N_CLIENTS), 10)
    fed = Federation.create(model, data, _t(tx), _t(ty).long(), cfg,
                            torch.Generator().manual_seed(0), device="cpu")
    p0 = params_from_jax({k: np.asarray(v) for k, v in
                          jax_softmax().init(jax.random.PRNGKey(1)).items()},
                         device="cpu")
    shapes = {k: (N_CLIENTS,) + tuple(v.shape) for k, v in p0.items()}
    idx, noise = _rsa_draws(0, rounds, N_CLIENTS, m, data.per_client,
                            shapes)
    lr = optim.inv_sqrt_lr(0.02)
    h = run_rsa(model, fed, cfg, lr, delta, params=p0, batch_idx=idx,
                noise=noise)
    assert h["round"] == jh["round"] == list(range(1, rounds + 1))
    assert h["acc"] == jh["acc"]
    assert len(log) == len(jlog) == rounds
    for k, v in jh["params"].items():
        np.testing.assert_array_equal(h["params"][k].numpy(), log[-1][k])
        np.testing.assert_array_equal(np.asarray(v), jlog[-1][k])
        tied = np.zeros(v.shape, bool)
        for r in range(rounds):
            got, want = log[r][k], jlog[r][k]
            off = ~np.isclose(got, want, rtol=1e-4, atol=1e-5) & ~tied
            steps = (got - want)[off] / (lr(r + 1) * delta)
            assert (np.abs(steps) > 0.99).all() and np.allclose(
                steps, np.round(steps), atol=1e-2), (k, r + 1, steps)
            tied |= off
        assert tied.sum() <= max(1, tied.size // 1000), (k, tied.sum())


def test_rsa_draws_from_its_generator():
    """The port's own draws: the same generator seed gives the same run;
    a Byzantine copy attack moves the master away from the honest run."""
    x, y = _numpy_mnist_like(1150, seed=0)
    tx, ty = _numpy_mnist_like(300, seed=9)
    model = softmax_regression()
    data = FederatedData.from_partitions(
        partition_sorted_shards(_t(x), _t(y).long(), N_CLIENTS), 10)
    runs = {}
    for attack in ("none", "gaussian", "gaussian"):
        cfg = FLConfig(rounds=4, aggregator="mean", batch_size=20,
                       attack=AttackConfig(kind=attack), eval_every=4)
        fed = Federation.create(model, data, _t(tx), _t(ty).long(), cfg,
                                device="cpu")
        h = run_rsa(model, fed, cfg, optim.inv_sqrt_lr(0.02),
                    generator=torch.Generator().manual_seed(3))
        runs.setdefault(attack, []).append(h["params"])
    a, b = runs["gaussian"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], runs["none"][0][k]) for k in a)


# ----------------------------------------------------------------------
# The rounds of the fixed-seed bars the port's draws miss
# ----------------------------------------------------------------------

@pytest.mark.parametrize("attack,scale,rounds,participation", [
    ("scale", 3.0, 30, 1.0), ("sign_flip", 5.0, 50, 0.5)])
def test_bar_rounds_match_the_reference(jax_guide_shim, attack, scale, rounds,
                                        participation):
    """The runs of two fixed-seed bars that the port's draws miss at its
    seed (the x3 scale attack's TPR 1, participation 0.5's FPR <= 0.1),
    from the same minibatches, the same participating clients (read from
    the reference's logs) and the same sealed samples: the same keep-masks
    every round and params to rtol 1e-4 / atol 1e-5.  The port's Steps
    2-5 are the reference's; what a round lets through is the draws'
    doing."""
    x, y = _numpy_mnist_like(4600, seed=0)
    tx, ty = _numpy_mnist_like(300, seed=9)
    m = 50
    jcfg = JaxFLConfig(n_clients=N_CLIENTS, f=F, rounds=rounds,
                       aggregator="diversefl",
                       attack=jax_attacks.AttackConfig(kind=attack,
                                                       scale=scale),
                       batch_size=m, participation=participation)
    jmodel = jax_softmax()
    jdata = JaxFederatedData.from_partitions(
        jax_partition(x, y, N_CLIENTS), 10)
    jfed = JaxFederation.create(jmodel, jdata, jnp.asarray(tx),
                                jnp.asarray(ty), jcfg, jax.random.PRNGKey(2))
    body = jax_make_round_body(jmodel, jfed, jcfg)
    jstep = jax.jit(lambda p, k, lr, b: body(p, k, lr, batch=b))

    cfg = FLConfig(n_clients=N_CLIENTS, f=F, rounds=rounds,
                   aggregator="diversefl",
                   attack=AttackConfig(kind=attack, scale=scale),
                   batch_size=m, participation=participation)
    model = softmax_regression()
    data = FederatedData.from_partitions(
        partition_sorted_shards(_t(x), _t(y).long(), N_CLIENTS), 10)
    fed = Federation.create(model, data, _t(tx), _t(ty).long(), cfg,
                            torch.Generator().manual_seed(0), device="cpu")
    for j in range(N_CLIENTS):
        sx, sy = jfed.server.enclave.unseal_samples(j)
        fed.server.ingest_samples(j, np.asarray(sx), np.asarray(sy))
    step = make_round_body(model, fed, cfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             device="cpu")
    draw = np.random.default_rng(5)
    rows = np.arange(N_CLIENTS)[:, None]
    jxs, jys = np.asarray(jdata.x), np.asarray(jdata.y)
    kept_byz = 0
    for r in range(1, rounds + 1):
        idx = draw.integers(0, jdata.per_client, size=(N_CLIENTS, m))
        lr = jax_optim.inv_sqrt_lr(0.05)(r)
        jparams, jlogs = jstep(jparams, jax.random.PRNGKey(r), lr,
                               (jnp.asarray(jxs[rows, idx]),
                                jnp.asarray(jys[rows, idx])))
        with torch.no_grad():
            params, logs = step(params, optim.inv_sqrt_lr(0.05)(r),
                                batch_idx=torch.from_numpy(idx),
                                sel=_t(jlogs["sel"]).long())
        assert len(logs["sel"]) == cfg.n_selected
        np.testing.assert_array_equal(logs["mask"].numpy(),
                                      np.asarray(jlogs["mask"]),
                                      err_msg=f"round {r}")
        for k in jparams:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(jparams[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"round {r} {k}")
        kept_byz += int(logs["mask"][logs["byz"]].sum())
    assert kept_byz < rounds * F


# ----------------------------------------------------------------------
# The sample-poisoning screen
# ----------------------------------------------------------------------

def _pretrain_idx(seed, steps, b, n):
    """The reference's pretraining draws: ``key, sub = split(key)`` each
    step, then ``randint(sub, (b,), 0, n)``."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (b,), 0, n)))
    return torch.from_numpy(np.stack(out)).long()


@pytest.mark.parametrize("name", ["softmax_regression", "mlp3"])
def test_pretrain_clean_model_matches_the_reference(name):
    """300 SGD steps (lr 0.1, batch 64) from the same initial params and
    the reference's indices: params to rtol 1e-5 / atol 1e-5."""
    jmodel, model = {"softmax_regression": (jax_softmax(),
                                            softmax_regression()),
                     "mlp3": (jax_mlp3(hidden=16), mlp3(hidden=16))}[name]
    cx, cy = _numpy_mnist_like(200, seed=77)
    fcfg = FilterConfig()
    jpre = jax_filter.pretrain_clean_model(
        jmodel, jnp.asarray(cx), jnp.asarray(cy),
        jax_filter.FilterConfig(), jax.random.PRNGKey(5))
    p0 = params_from_jax({k: np.asarray(v) for k, v in
                          jmodel.init(jax.random.PRNGKey(5)).items()},
                         device="cpu")
    idx = _pretrain_idx(5, fcfg.pretrain_steps, fcfg.pretrain_batch, 200)
    pre = pretrain_clean_model(model, _t(cx), _t(cy).long(), fcfg, idx=idx,
                               params=p0, device="cpu")
    for k, v in jpre.items():
        np.testing.assert_allclose(pre[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_screen_clients_matches_the_reference():
    """The same pretrained params and the same sealed samples, some of
    them label-flipped in part or in whole: the same accepted ids, the
    same accuracies, the same clients left in the store, and every drop
    bumps the seal version."""
    cx, cy = _numpy_mnist_like(200, seed=77)
    jmodel, model = jax_softmax(), softmax_regression()
    jpre = jax_filter.pretrain_clean_model(
        jmodel, jnp.asarray(cx), jnp.asarray(cy),
        jax_filter.FilterConfig(), jax.random.PRNGKey(5))
    pre = params_from_jax({k: np.asarray(v) for k, v in jpre.items()},
                          device="cpu")
    sx, sy = _numpy_mnist_like(8 * 10, seed=3)
    jenc, enc = JaxEnclave(), Enclave(device="cpu")
    for c in range(8):
        xs, ys = sx[c * 10:(c + 1) * 10], sy[c * 10:(c + 1) * 10].copy()
        ys[:c + (c > 3) * 4] = 9 - ys[:c + (c > 3) * 4]   # 0..10 flipped
        jenc.seal_samples(c, xs, ys)
        enc.seal_samples(c, xs, ys)
    v0 = enc.seal_version
    fcfg = FilterConfig()
    jacc, jaccs = jax_filter.screen_clients(jmodel, jpre, jenc,
                                            jax_filter.FilterConfig())
    acc, accs = screen_clients(model, pre, enc, fcfg)
    assert acc == jacc and 0 < len(acc) < 8
    assert accs == jaccs and list(accs) == list(range(8))
    assert enc.client_ids() == jenc.client_ids() == acc
    assert enc.seal_version == v0 + 8 - len(acc)


def test_pretrain_refuses_to_choose_for_the_caller(monkeypatch):
    cx, cy = _numpy_mnist_like(100, seed=1)
    model = softmax_regression()
    with pytest.raises(ValueError, match="generator or idx"):
        pretrain_clean_model(model, _t(cx), _t(cy).long(), FilterConfig(),
                             device="cpu")
    with pytest.raises(ValueError, match=r"\(300, 64\)"):
        pretrain_clean_model(model, _t(cx), _t(cy).long(), FilterConfig(),
                             idx=torch.zeros(3, 64, dtype=torch.long),
                             device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_clean_model(model, _t(cx), _t(cy).long(), FilterConfig(),
                             torch.Generator())


@pytest.mark.parametrize("batch", [64, 2048])
def test_small_model_accuracy_matches_the_reference(batch):
    """A host float from whole-batch integer counts, equal to the
    reference's, whether the rows fit one batch or not."""
    jmodel, model = jax_mlp3(hidden=16), mlp3(hidden=16)
    jp = jmodel.init(jax.random.PRNGKey(4))
    p = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                        device="cpu")
    x, y = _numpy_mnist_like(300, seed=2)
    want = jmodel.accuracy(jp, jnp.asarray(x), jnp.asarray(y), batch)
    got = model.accuracy(p, _t(x), _t(y).long(), batch)
    assert isinstance(got, float) and got == want


# ----------------------------------------------------------------------
# SGD and the schedules
# ----------------------------------------------------------------------

def test_sgd_plain_and_momentum():
    """tests/test_substrate.py's values."""
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 2.0)}
    p1, s = optim.sgd_step(p, g, optim.sgd_init(p), lr=0.1)
    assert s == ()
    np.testing.assert_allclose(p1["w"].numpy(), 0.8)
    st = optim.sgd_init(p, momentum=0.9)
    p2, st = optim.sgd_step(p, g, st, lr=0.1, momentum=0.9)
    p3, st = optim.sgd_step(p2, g, st, lr=0.1, momentum=0.9)
    np.testing.assert_allclose(p3["w"].numpy(), 1.0 - 0.2 - 0.1 * (0.9 * 2 + 2),
                               rtol=1e-6)


@pytest.mark.parametrize("momentum,weight_decay",
                         [(0.0, 0.0), (0.0, 1e-3), (0.9, 0.0), (0.9, 5e-4)])
def test_sgd_step_matches_the_reference(momentum, weight_decay):
    """Five steps on random fp32 params: params and state to fp32 rounding
    (rtol 1e-6, atol 1e-7); a bf16 leaf stays bf16, within one bf16 step."""
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(size=(6, 5)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jp["h"] = jnp.asarray(p["b"]).astype(jnp.bfloat16)
    tp["h"] = _t(p["b"]).to(torch.bfloat16)
    js = jax_optim.sgd_init(jp, momentum)
    ts = optim.sgd_init(tp, momentum)
    for i in range(5):
        g = {k: rng.normal(size=np.shape(v)).astype(np.float32)
             for k, v in p.items()}
        g["h"] = g["b"]
        jp, js = jax_optim.sgd_step(jp, {k: jnp.asarray(v) for k, v in
                                         g.items()}, js, 0.05, momentum,
                                    weight_decay)
        tp, ts = optim.sgd_step(tp, {k: _t(v) for k, v in g.items()}, ts,
                                0.05, momentum, weight_decay)
    assert tp["h"].dtype == torch.bfloat16
    for k in ("w", "b"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        if momentum:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp["h"].float().numpy(),
                               np.asarray(jp["h"].astype(jnp.float32)),
                               rtol=2 ** -7)


def test_apply_update():
    p = {"w": torch.ones(2), "v": torch.ones(3, dtype=torch.bfloat16)}
    u = {"w": torch.full((2,), 0.5), "v": torch.full((3,), 0.25)}
    out = optim.apply_update(p, u)
    np.testing.assert_allclose(out["w"].numpy(), 0.5)
    assert out["v"].dtype == torch.bfloat16
    np.testing.assert_allclose(out["v"].float().numpy(), 0.75)
    out = optim.apply_update(p, u, scale=2.0)
    ref = jax_optim.apply_update({"w": jnp.ones(2)},
                                 {"w": jnp.full((2,), 0.5)}, 2.0)
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(ref["w"]))


def test_schedules_substrate_values():
    """tests/test_substrate.py's values."""
    assert optim.constant_lr(0.1)(100) == pytest.approx(0.1)
    assert optim.inv_sqrt_lr(0.001)(4) == pytest.approx(0.0005)
    s = optim.step_decay_lr(0.06, [500, 950], 0.5)
    assert s(1) == pytest.approx(0.06)
    assert s(500) == pytest.approx(0.03)
    assert s(950) == pytest.approx(0.015)
    w = optim.warmup_then_step_lr(0.05, 0.1, 1000, [2000], 0.4)
    assert w(0) == pytest.approx(0.05)
    assert w(1000) == pytest.approx(0.1)
    assert w(2000) == pytest.approx(0.04)


@pytest.mark.parametrize("name,args", [
    ("step_decay_lr", (0.06, [500, 950], 0.5)),
    ("step_decay_lr", (0.1, [100, 200, 300, 1500], 0.1)),
    ("warmup_then_step_lr", (0.05, 0.1, 1000, [2000], 0.4)),
    ("warmup_then_step_lr", (0.01, 0.3, 7, [30, 2500], 0.3)),
    ("warmup_then_step_lr", (0.02, 0.2, 0, [10], 0.5)),
])
def test_schedules_match_the_reference_to_one_ulp(name, args):
    """Host floats, equal to the reference's float32 to one float32 ulp
    at every round 0-3,000."""
    mine, ref = getattr(optim, name)(*args), getattr(jax_optim, name)(*args)
    got = np.array([mine(i) for i in range(3001)], np.float32)
    want = np.array([np.float32(ref(i)) for i in range(3001)], np.float32)
    assert isinstance(mine(3), float)
    assert (np.abs(got - want) <= np.spacing(want)).all()


# ----------------------------------------------------------------------
# DiverseFL's dict-params forms, the tree attack, the batch iterator
# ----------------------------------------------------------------------

CFG = DiverseFLConfig()


def test_similarity_stats_flat_matches_the_reference():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(4, 9)).astype(np.float32)
    g = rng.normal(size=(4, 9)).astype(np.float32)
    want = jax_dfl.similarity_stats(jnp.asarray(z), jnp.asarray(g))
    got = similarity_stats(_t(z), _t(g))
    for a, b in zip(got, want):
        assert a.dim() == 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_similarity_stats_tree_matches_the_reference_and_flat():
    """tests/test_diversefl_unit.py's case: per-leaf fp32 sums summed over
    the leaves equal the flat stats (rtol 1e-5) and the reference's."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 7)).astype(np.float32)
    b = rng.normal(size=(11,)).astype(np.float32)
    z = {"x": a, "y": b}
    g = {"x": a * 0.5, "y": b * 0.5}
    want = jax_dfl.similarity_stats_tree(
        {k: jnp.asarray(v) for k, v in z.items()},
        {k: jnp.asarray(v) for k, v in g.items()})
    got = similarity_stats_tree({k: _t(v) for k, v in z.items()},
                                {k: _t(v) for k, v in g.items()})
    flat_z = np.concatenate([a.ravel(), b])
    flat = (flat_z @ (flat_z * 0.5), flat_z @ flat_z,
            (flat_z * 0.5) @ (flat_z * 0.5))
    for x, w, f in zip(got, want, flat):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-5)
        np.testing.assert_allclose(x.numpy(), f, rtol=1e-5)


@pytest.mark.parametrize("mask", [
    np.array([1, 0, 1, 1, 0, 1], bool),
    np.array([0.5, 0.0, 1.0, 2.0, 0.0, 1.0], np.float32),
    np.zeros(6, bool),
])
def test_masked_mean_matches_the_reference(mask):
    """Bool and float masks and the all-false mask (the zero update), over
    leaves of several ranks: fp32 tolerance (rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(0)
    u = {"a": rng.normal(size=(6, 5)).astype(np.float32),
         "b": rng.normal(size=(6, 2, 3)).astype(np.float32),
         "c": rng.normal(size=(6,)).astype(np.float32)}
    want = jax_dfl.masked_mean({k: jnp.asarray(v) for k, v in u.items()},
                               jnp.asarray(mask))
    got = masked_mean({k: _t(v) for k, v in u.items()}, _t(mask))
    for k in u:
        assert got[k].shape == u[k].shape[1:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    if not mask.any():
        assert all(not v.any() for v in got.values())


def test_diversefl_aggregate_matches_the_reference():
    """tests/test_diversefl_unit.py's end-to-end case over two leaves: the
    same mask, the aggregate and the stats to fp32 tolerance."""
    rng = np.random.default_rng(0)
    n = 6
    g = {"w": rng.normal(size=(n, 5, 10)).astype(np.float32),
         "b": rng.normal(size=(n, 10)).astype(np.float32)}
    z = {k: v.copy() for k, v in g.items()}
    for v in z.values():
        v[2] = -v[2]            # sign flip
        v[4] = v[4] * 10.0      # huge scale
    jagg, jmask, jstats = jax_dfl.diversefl_aggregate(
        {k: jnp.asarray(v) for k, v in z.items()},
        {k: jnp.asarray(v) for k, v in g.items()}, jax_dfl.DiverseFLConfig())
    agg, mask, stats = diversefl_aggregate(
        {k: _t(v) for k, v in z.items()}, {k: _t(v) for k, v in g.items()},
        CFG)
    assert mask.tolist() == [True, True, False, True, False, True]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    for k in z:
        np.testing.assert_allclose(agg[k].numpy(), np.asarray(jagg[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(agg[k].numpy(),
                                   z[k][[0, 1, 3, 5]].mean(0), rtol=1e-5,
                                   atol=1e-6)
    assert set(stats) == set(jstats) == {"dot", "z_norm_sq", "g_norm_sq",
                                         "c2"}
    for k in stats:
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["gaussian", "sign_flip", "same_value",
                                  "scale", "backdoor", "label_flip", "none"])
def test_attack_update_tree_matches_the_reference(kind):
    """Leaf by leaf; gaussian from the reference's per-leaf keys
    (``split(key, n_leaves)`` over its sorted leaves), injected."""
    rng = np.random.default_rng(5)
    u = {"w": rng.normal(size=(4, 3)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    key = jax.random.PRNGKey(8)
    jcfg = jax_attacks.AttackConfig(kind=kind, sigma=3.0, scale=2.5)
    want = jax_attacks.attack_update_tree(
        {k: jnp.asarray(v) for k, v in u.items()}, kind, key, jcfg)
    keys = jax.random.split(key, len(u))
    noise = {k: _t(jax.random.normal(kk, (u[k].size,)).reshape(u[k].shape))
             for k, kk in zip(sorted(u), keys)}
    got = attack_update_tree({k: _t(v) for k, v in u.items()}, kind,
                             AttackConfig(kind=kind, sigma=3.0, scale=2.5),
                             noise=noise)
    for k in u:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    if kind == "gaussian":
        gen = torch.Generator().manual_seed(0)
        a = attack_update_tree({k: _t(v) for k, v in u.items()}, kind,
                               AttackConfig(kind=kind), gen)
        assert not torch.equal(a["w"].flatten()[:3], a["b"])


def test_batch_iterator_matches_the_reference():
    """Five batches from the reference's chain (``key, sub = split(key)``,
    ``randint(sub, (b,), 0, n)``), injected: the same rows; then the
    injected iterator stops, and the drawn one goes on."""
    x, y = _numpy_mnist_like(40, seed=6)
    it = jax_batch_iterator(jax.random.PRNGKey(3), jnp.asarray(x),
                            jnp.asarray(y), 8)
    want = [next(it) for _ in range(5)]
    key = jax.random.PRNGKey(3)
    idx = []
    for _ in range(5):
        key, sub = jax.random.split(key)
        idx.append(np.asarray(jax.random.randint(sub, (8,), 0, 40)))
    got = list(batch_iterator(None, _t(x), _t(y).long(), 8,
                              idx=torch.from_numpy(np.stack(idx)).long()))
    assert len(got) == 5
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    drawn = batch_iterator(torch.Generator().manual_seed(0), _t(x),
                           _t(y).long(), 8)
    for _ in range(7):
        bx, by = next(drawn)
        assert bx.shape == (8, 28, 28) and by.shape == (8,)
    with pytest.raises(ValueError, match=r"\(steps, 8\)"):
        batch_iterator(None, _t(x), _t(y), 8, idx=torch.zeros(5, 7).long())
    assert ClientDataset(_t(x), _t(y)).n == 40


# ----------------------------------------------------------------------
# What of the reference the port holds
# ----------------------------------------------------------------------

CENSUS = ["core/aggregators", "core/diversefl", "core/attacks",
          "core/sample_filter", "core/tee", "data/synthetic",
          "data/partition", "data/pipeline", "optim/adam", "optim/sgd",
          "optim/schedules", "checkpoint/store", "fl/chunking",
          "fl/compression", "fl/metrics", "fl/server", "fl/simulator",
          "fl/streaming", "fl/rsa", "fl/small_models", "fl/faults",
          "fl/telemetry", "fl/sweep", "fl/engine", "fl/zoo", "kernels/ops",
          "models/config", "models/layers", "models/attention",
          "models/mamba", "models/moe", "models/frontends", "models/model",
          "launch/observe", "launch/serve", "sharding/api", "launch/mesh",
          "launch/train", "launch/shapes", "launch/dryrun",
          "launch/hlo"] + [
    "configs/" + a for a in ("gemma_2b", "whisper_medium", "deepseek_moe_16b",
                             "kimi_k2_1t_a32b", "h2o_danube_1_8b",
                             "granite_20b", "llama_3_2_vision_90b",
                             "jamba_v0_1_52b", "minitron_8b",
                             "falcon_mamba_7b")]
# Every module of the port with a reference counterpart, but the six
# kernel implementations (kernels/similarity, masked_agg, robust_agg,
# dequant_fold, flash_attention, mamba_scan): their public names are the
# Pallas programs and TPU block sizes, whose counterparts are CUDA sources
# that the kernel tests and chip_smoke.py hold against the plain versions.
# Each name the port leaves out, with the ROADMAP item that takes it:
EXCLUDED = {}
# Each name the port carries under another, with why: the reference's
# roofline figures are the TPU v5e's inter-chip links, the port's the
# H100's NVLink
RENAMED = {"launch/hlo.ICI_BW_PER_LINK": "NVLINK_BW_PER_LINK",
           "launch/hlo.ICI_LINKS": "NVLINK_LINKS"}


def _public_names(path):
    """Public top-level names a module defines (functions, classes,
    assigned constants) and its classes' public methods, read with
    ``ast`` without importing the module."""
    names = []
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{f.name}" for f in node.body
                          if isinstance(f, ast.FunctionDef)]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.split(".")[-1].startswith("_")]


def test_every_public_reference_name_has_a_port_counterpart():
    seen = set()
    for mod in CENSUS:
        port = importlib.import_module("repro_torch." + mod.replace("/", "."))
        for name in _public_names(ROOT / "src" / "repro" / (mod + ".py")):
            full = f"{mod}.{name}"
            obj = port
            for part in name.split("."):
                obj = getattr(obj, part, None)
            if full in EXCLUDED:
                seen.add(full)
                assert obj is None, f"{full} is ported: drop its exclusion"
                assert re.match(r"S\d", EXCLUDED[full])
            elif full in RENAMED:
                seen.add(full)
                assert obj is None, f"the port still has {full}"
                assert getattr(port, RENAMED[full], None) is not None, \
                    f"the port lacks {mod}.{RENAMED[full]}"
            else:
                assert obj is not None, f"the port lacks {full}"
    assert seen == set(EXCLUDED) | set(RENAMED), \
        (set(EXCLUDED) | set(RENAMED)) - seen


def test_every_reference_example_has_a_port_entry_point():
    """Each ``examples/*.py`` of the reference has a module of the same
    name in ``repro_torch.examples`` with a ``main``."""
    names = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert names == ["attack_gallery", "paper_grid", "quickstart",
                     "serve_decode", "train_fl_llm"]
    for name in names:
        mod = importlib.import_module("repro_torch.examples." + name)
        assert callable(getattr(mod, "main", None)), name


def test_ported_names_are_exported_like_the_reference():
    """The package-level exports of the three packages this slice
    completes, and RSA's module on ``repro_torch.fl``."""
    import repro_torch.core as core
    import repro_torch.data as data
    import repro_torch.fl as fl
    for pkg, names in ((core, ["similarity_stats", "similarity_stats_tree",
                               "masked_mean", "diversefl_aggregate",
                               "sample_filter"]),
                       (data, ["ClientDataset", "batch_iterator"]),
                       (optim, ["sgd_init", "sgd_step", "apply_update",
                                "step_decay_lr", "warmup_then_step_lr"]),
                       (fl, ["rsa"])):
        for n in names:
            assert hasattr(pkg, n), (pkg.__name__, n)
