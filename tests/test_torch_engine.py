"""The port's round engine (``repro_torch.fl.engine``) on the CPU.

* The engine equals the per-round loop bit for bit (history and params):
  diversefl, oracle, mean and fltrust; dense and streaming; f32 and
  int8; ``batch_mode`` inline and segment; eval_every 1 and > 1; and the
  host-eval loop too.
* One ``host_sync`` per run in engine mode, one per eval point under
  ``host_eval=True`` and in the per-round loop.
* With the reference's draws injected (the minibatch indices rebuilt from
  its key chain), the port's engine matches
  ``repro.fl.engine.RoundEngine``: masks exactly every round, params and
  the eval history to fp32 tolerance (atol 1e-5, rtol 1e-4).
* The named refusals: ``graph=True`` off the card, a ``mesh=`` that is
  not a ``DeviceMesh``, a dense config on a model axis > 1, a segment
  batch mode its draws cannot honour, ``donate=True``.
"""
import jax
import numpy as np
import pytest
import torch

import repro_torch.fl.simulator as simulator
from _torch_s5 import (LR, cfg, federation, jax_cfg, jax_federation, model,
                       port_data, port_fed_like, reference_draws,
                       same_history)
from repro.fl.engine import RoundEngine as JaxRoundEngine
from repro.fl.simulator import _lr_vector as jax_lr_vector
from repro.optim import inv_sqrt_lr as jax_inv_sqrt_lr
from repro_torch.convert import params_from_jax
from repro_torch.core.attacks import AttackConfig
from repro_torch.fl import RoundEngine, run_federated_training, trace_counter
from repro_torch.fl.engine import TRACE_COUNTS, TraceDelta, trace_counts

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_guide_shim(monkeypatch):
    """The reference's guide cache calls ``jax.core.trace_state_clean``,
    which JAX 0.9 moved to ``jax._src.core``.  Point the old name at it for
    this test only."""
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


@pytest.fixture(scope="module")
def data():
    return port_data()


def _run(c, data, **kw):
    fed = federation(c, data)
    return run_federated_training(model(), fed, c, LR, **kw)


ENGINE_CASES = [
    dict(aggregator="diversefl"),
    dict(aggregator="diversefl", eval_every=1),
    dict(aggregator="oracle"),
    dict(aggregator="mean", attack=AttackConfig(kind="gaussian",
                                                sigma=10.0)),
    dict(aggregator="fltrust"),
    dict(aggregator="diversefl", streaming=True, client_chunk=4),
    dict(aggregator="oracle", streaming=True, client_chunk=3),
    dict(aggregator="mean", streaming=True, client_chunk=4),
    dict(aggregator="fltrust", streaming=True, client_chunk=4),
    dict(aggregator="diversefl", compression="int8"),
    dict(aggregator="diversefl", streaming=True, client_chunk=4,
         compression="int8", eval_every=1),
    dict(aggregator="mean", streaming=True, client_chunk=4,
         compression="int8"),
    dict(aggregator="diversefl", participation=0.6),
]


@pytest.mark.parametrize("kw", ENGINE_CASES,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in
                                                 kw.items()
                                                 if k != "attack"))
def test_engine_equals_the_per_round_loop_bitwise(data, kw):
    c = cfg(**kw)
    h_loop = _run(c, data, use_engine=False)
    h_eng = _run(c, data)
    h_host = _run(c, data, host_eval=True)
    assert same_history(h_eng, h_loop)
    assert same_history(h_host, h_loop)
    assert h_eng["round"] == [r for r in range(1, c.rounds + 1)
                              if r % c.eval_every == 0 or r == c.rounds]


def test_segment_batch_mode_is_bitwise(data):
    c = cfg(aggregator="diversefl", streaming=True, client_chunk=4)
    h_loop = _run(c, data, use_engine=False)
    fed = federation(c, data)
    eng = RoundEngine(model(), fed, c, batch_mode="segment")
    h_seg = run_federated_training(model(), fed, c, LR, engine=eng)
    assert same_history(h_seg, h_loop)
    with pytest.raises(ValueError, match="gaussian attack noise"):
        RoundEngine(model(), fed, cfg(attack=AttackConfig(kind="gaussian")),
                    batch_mode="segment")
    with pytest.raises(ValueError, match="unknown batch_mode"):
        RoundEngine(model(), fed, c, batch_mode="scan")


def test_segment_minibatches_equal_the_inline_draws(data):
    d, _, _ = data
    a = d.segment_minibatches(3, 5, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    rows = [d.minibatch(5, g) for _ in range(3)]
    assert torch.equal(a[0], torch.stack([r[0] for r in rows]))
    assert torch.equal(a[1], torch.stack([r[1] for r in rows]))
    idx = torch.zeros((3, d.n_clients, 5), dtype=torch.long)
    bx, by = d.segment_minibatches(3, 5, idx=idx)
    assert torch.equal(bx[2, :, 0], d.x[:, 0])
    with pytest.raises(ValueError, match=r"\(3, 10, 5\)"):
        d.segment_minibatches(3, 5, idx=idx[:, :, :4])


@pytest.mark.parametrize("mode,eval_every,want", [
    (dict(), 2, 1), (dict(), 1, 1), (dict(host_eval=True), 2, 3),
    (dict(use_engine=False), 2, 3), (dict(use_engine=False), 1, 5)])
def test_host_syncs_per_run(data, monkeypatch, mode, eval_every, want):
    calls = []
    real = simulator.host_sync

    def counted(tree):
        calls.append(1)
        return real(tree)
    monkeypatch.setattr(simulator, "host_sync", counted)
    _run(cfg(eval_every=eval_every, telemetry=True), data, **mode)
    assert len(calls) == want


def test_run_segment_returns_the_last_rounds_logs(data):
    c = cfg(aggregator="diversefl")
    fed = federation(c, data)
    eng = RoundEngine(model(), fed, c)
    p0 = model().init(torch.Generator().manual_seed(c.seed + 1), "cpu")
    lrs = torch.tensor([LR(i) for i in range(1, 4)])
    carry, logs = eng.run_segment(p0, torch.Generator().manual_seed(0), lrs)
    body = simulator.make_round_body(model(), fed, c)
    g = torch.Generator().manual_seed(0)
    p = p0
    for i in range(3):
        p, want = body(p, lrs[i], g)
    assert torch.equal(logs["mask"], want["mask"])
    assert all(torch.equal(carry[k], p[k]) for k in p)


def test_donate_true_is_refused_by_name(data):
    """The port has no buffer donation: donate=True is refused, and the
    engine leaves the caller's carry tensors untouched."""
    with pytest.raises(ValueError, match="no buffer donation"):
        cfg(donate=True)
    for donate in (None, False):
        c = cfg(donate=donate)
        eng = RoundEngine(model(), federation(c, data), c)
        p0 = model().init(torch.Generator().manual_seed(1), "cpu")
        keep = {k: v.clone() for k, v in p0.items()}
        lrs = torch.tensor([LR(i) for i in range(1, 6)])
        params, _, _, _ = eng.run_training(
            p0, torch.Generator().manual_seed(0), lrs)
        assert all(torch.equal(p0[k], keep[k]) for k in p0)
        assert not all(torch.equal(p0[k], params[k]) for k in p0)


def test_refusals_are_named(data):
    c = cfg()
    fed = federation(c, data)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        RoundEngine(model(), fed, c, graph=True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        RoundEngine(model(), fed, c, mesh=object())
    with pytest.raises(ValueError, match="model-sharded run.*streaming"):
        cfg(streaming=False).validate_model_sharding(100, 2)


def test_build_counter_counts_engines(data):
    c = cfg()
    fed = federation(c, data)
    before = trace_counts()
    with trace_counter() as tc:
        eng = RoundEngine(model(), fed, c)
        assert tc["build"] == 1
        run_federated_training(model(), fed, c, LR, engine=eng)
        run_federated_training(model(), fed, c, LR, engine=eng)
    assert tc.snapshot() == {"build": 1, "capture": 0}
    assert tc.total() == 1
    assert trace_counts()["build"] == before["build"] + 1
    assert isinstance(tc, TraceDelta) and set(TRACE_COUNTS) == {"build",
                                                                "capture"}


@pytest.mark.parametrize("kw", [dict(), dict(streaming=True, client_chunk=4)],
                         ids=["dense", "streaming"])
def test_engine_matches_the_reference_with_injected_draws(jax_guide_shim,
                                                          kw):
    """diversefl under sign_flip, 5 rounds: the reference engine's
    history and params, the port's engine fed the reference's minibatch
    indices and sealed samples.  Masks equal every round; params within
    atol 1e-5, rtol 1e-4."""
    c = cfg(aggregator="diversefl", eval_every=2, **kw)
    jc = jax_cfg(c)
    jmodel, jfed = jax_federation(jc)
    fed = port_fed_like(c, jfed)
    draws = reference_draws(jc, jfed.data)
    jlrs = jax_lr_vector(jax_inv_sqrt_lr(0.05), c.rounds)
    lrs = torch.from_numpy(np.array(jlrs))
    jparams0 = jmodel.init(jax.random.PRNGKey(c.seed + 1))
    params0 = params_from_jax({k: np.asarray(v) for k, v in
                               jparams0.items()}, device="cpu")
    jeng = JaxRoundEngine(jmodel, jfed, jc)
    eng = RoundEngine(model(), fed, c)
    gen = torch.Generator().manual_seed(0)

    # round by round: the keep masks exactly, params to tolerance
    jcarry, key, p = jparams0, jax.random.PRNGKey(c.seed), params0
    for r in range(c.rounds):
        jcarry, key, jlogs = jeng.run_segment(jcarry, key, jlrs[r:r + 1])
        p, logs = eng.run_segment(p, gen, lrs[r:r + 1],
                                  draws={k: v[r:r + 1]
                                         for k, v in draws.items()})
        np.testing.assert_array_equal(logs["mask"].numpy(),
                                      np.asarray(jlogs["mask"]),
                                      err_msg=f"round {r + 1}")
        for k in p:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jcarry[k]),
                                       atol=ATOL, rtol=RTOL)
    assert not logs["mask"][fed.byz_mask].any()

    # the whole run: the eval history and the final params
    jp, _, jm, jrounds = jeng.run_training(jparams0,
                                           jax.random.PRNGKey(c.seed), jlrs)
    pp, _, m, rounds = eng.run_training(params0, gen, lrs, draws=draws)
    assert rounds == jrounds
    host = simulator.host_sync(m)
    for k in ("acc", "mask_tpr", "mask_fpr"):
        np.testing.assert_array_equal(host[k], np.asarray(jm[k]), err_msg=k)
    np.testing.assert_allclose(host["c1c2"], np.asarray(jm["c1c2"]),
                               atol=ATOL, rtol=RTOL)
    for k in pp:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   atol=ATOL, rtol=RTOL)
