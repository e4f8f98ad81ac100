"""Async federated rounds of the port (``repro_torch.fl.faults`` and the
async branch of ``make_round_body``) on the CPU.

* The fault primitives and every named refusal of ``FaultConfig`` and
  ``FLConfig``'s async knobs; ``DegenerateCohortError``.
* Trivial async (``cohort_participation=1.0``, no fault) equals the
  synchronous run bit for bit; every fault kind runs the engine bitwise
  its per-round loop.
* With the reference's draws injected (minibatch indices, the cohort
  chain and the fault rows, rebuilt from its key chain), dropout,
  stragglers with a staleness buffer and intermittent corruption match
  ``repro.fl.engine.RoundEngine``: the keep masks, ``cand``, the per-round
  cohort and ``stale_*`` counts exactly, params to fp32 tolerance (atol
  1e-5, rtol 1e-4), and the telemetry block too.
* The staleness bookkeeping (buffered, folded, expired) balances, and the
  accounting scores a straggler at its landing round.
"""
import jax
import numpy as np
import pytest
import torch

import repro_torch.fl.simulator as simulator
from _torch_s5 import (LR, cfg, federation, jax_cfg, jax_federation, model,
                       port_data, port_fed_like, reference_cohort,
                       reference_draws, same_history)
from repro.fl.engine import RoundEngine as JaxRoundEngine
from repro.fl.engine import make_scenario as jax_make_scenario
from repro.fl.simulator import _lr_vector as jax_lr_vector
from repro.fl.telemetry import make_round_telemetry_fn as jax_tel_fn
from repro.optim import inv_sqrt_lr as jax_inv_sqrt_lr
from repro_torch.convert import params_from_jax
from repro_torch.fl import RoundEngine, run_federated_training
from repro_torch.fl.faults import (DegenerateCohortError, FaultConfig,
                                   cohort_size, corrupt_updates, draw_faults,
                                   init_async_state, make_cohort_chain,
                                   validate_cohort_chain)
from repro_torch.fl.metrics import mask_rates
from repro_torch.fl.telemetry import make_round_telemetry_fn

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


def acfg(fault=None, **kw):
    """An async streaming diversefl config."""
    base = dict(aggregator="diversefl", streaming=True, client_chunk=4)
    if fault is not None:
        base["fault"] = fault
    base.update(kw)
    return cfg(**base)


def _run(c, data, **kw):
    return run_federated_training(model(), federation(c, data), c, LR, **kw)


def test_fault_config_named_errors():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultConfig(kind="meteor")
    with pytest.raises(ValueError, match=r"rate must be in \[0, 1\]"):
        FaultConfig(kind="dropout", rate=1.5)
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="delay must be a positive int"):
            FaultConfig(kind="straggler", delay=bad)
    with pytest.raises(ValueError, match="unknown corruption mode"):
        FaultConfig(kind="intermittent", mode="zero")
    assert hash(FaultConfig()) == hash(FaultConfig())
    assert not FaultConfig().draws and not FaultConfig("dropout").draws
    assert FaultConfig("dropout", rate=0.1).draws


@pytest.mark.parametrize("kw,match", [
    (dict(fault="dropout"), "fault must be a fl.faults.FaultConfig"),
    (dict(cohort_participation=0.0), "cohort_participation must be"),
    (dict(cohort_participation=True), "cohort_participation must be"),
    (dict(staleness_buffer=-1), "staleness_buffer must be a non-negative"),
    (dict(staleness_cap=1.5), "staleness_cap must be a non-negative"),
    (dict(staleness_discount=0.0), "staleness_discount must be in"),
    (dict(staleness_discount=1.5), "staleness_discount must be in"),
    (dict(staleness_buffer=2, participation=0.5),
     "set participation=1.0"),
    (dict(staleness_buffer=2, streaming=False), "streaming=False"),
    (dict(staleness_buffer=2, aggregator="median"),
     "aggregator 'median' has no streaming rule"),
    (dict(staleness_buffer=2, compression="int8"),
     "cannot compose with the lossy"),
])
def test_flconfig_async_refusals_are_named(kw, match):
    base = dict(aggregator="diversefl", streaming=True)
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        cfg(**base)


def test_async_rounds_property():
    assert not cfg().async_rounds
    assert acfg(cohort_participation=1.0).async_rounds
    assert acfg(staleness_buffer=1).async_rounds
    assert acfg(FaultConfig("dropout", rate=0.1)).async_rounds


def test_cohort_chain_shape_size_and_determinism():
    g = torch.Generator().manual_seed(5)
    chain = make_cohort_chain(10, 6, 0.35, g)
    assert chain.shape == (6, 10) and chain.dtype == torch.bool
    assert (chain.sum(1) == cohort_size(10, 0.35)).all()
    again = make_cohort_chain(10, 6, 0.35, torch.Generator().manual_seed(5))
    assert torch.equal(chain, again)
    assert cohort_size(10, 0.01) == 1 and cohort_size(10, 1.0) == 10
    assert not torch.equal(chain[0], chain[1]) or not torch.equal(chain[1],
                                                                  chain[2])


def test_explicit_chain_validation():
    ok = np.ones((3, 4), bool)
    validate_cohort_chain(ok, 4, 3)
    bad = ok.copy()
    bad[1] = False
    with pytest.raises(DegenerateCohortError, match="zero clients in round 1"):
        validate_cohort_chain(bad, 4, 3)
    with pytest.raises(DegenerateCohortError, match="shape"):
        validate_cohort_chain(ok, 5, 3)
    assert issubclass(DegenerateCohortError, ValueError)
    c = acfg(cohort_participation=0.5)
    with pytest.raises(DegenerateCohortError):
        simulator.make_scenario(c, cohort=np.zeros((c.rounds, c.n_clients),
                                                   bool), device="cpu")


def test_draw_and_corrupt_primitives():
    none = draw_faults(6, FaultConfig(), torch.Generator().manual_seed(0))
    assert none.dtype == torch.bool and not none.any()
    g = torch.Generator().manual_seed(0)
    rows = draw_faults(4000, FaultConfig("dropout", rate=0.25), g)
    assert 0.2 < rows.float().mean().item() < 0.3
    U = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 1
    f = torch.tensor([True, False, True])
    nan = corrupt_updates(U, f, FaultConfig("intermittent", 0.5, mode="nan"))
    assert torch.isnan(nan[0]).all() and torch.equal(nan[1], U[1])
    inf = corrupt_updates(U, f, FaultConfig("intermittent", 0.5, mode="inf"))
    assert torch.isinf(inf[2]).all()
    flip = corrupt_updates(U, f, FaultConfig("intermittent", 0.5,
                                             mode="bitflip"))
    assert torch.equal(flip[0], U[0] * 128.0) and torch.equal(flip[1], U[1])
    assert torch.equal(corrupt_updates(U, f, FaultConfig("dropout", 0.5)), U)
    st = init_async_state(acfg(staleness_buffer=3), (7,))
    assert st["u"].shape == (3, 7) and not st["on"].any() and st["r"] == 0
    assert init_async_state(cfg(), (7,)) is None
    assert set(init_async_state(acfg(cohort_participation=0.5),
                                (7,))) == {"r"}


def test_mask_rates_valid_channel():
    mask = torch.tensor([True, False, False, True, False])
    byz = torch.tensor([False, True, False, False, True])
    valid = torch.tensor([True, True, True, False, False])
    tpr, fpr = mask_rates(mask, byz, valid)
    assert tpr.item() == 1.0 and fpr.item() == 0.5
    tpr, fpr = mask_rates(mask, byz)
    assert tpr.item() == 1.0 and fpr.item() == pytest.approx(1 / 3)
    tpr, fpr = mask_rates(mask, byz, torch.zeros(5, dtype=torch.bool))
    assert tpr.item() == 1.0 and fpr.item() == 0.0


def test_trivial_async_equals_the_sync_run_bitwise(data):
    sync = acfg()
    triv = acfg(cohort_participation=1.0)
    assert triv.async_rounds and not sync.async_rounds
    assert same_history(_run(triv, data), _run(sync, data))


FAULTS = [FaultConfig("dropout", rate=0.3),
          FaultConfig("straggler", rate=0.3, delay=1),
          FaultConfig("straggler", rate=0.4, delay=2),
          FaultConfig("intermittent", rate=0.3, mode="nan"),
          FaultConfig("intermittent", rate=0.3, mode="bitflip")]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=lambda f: f"{f.kind}-{f.mode}-{f.delay}")
def test_async_engine_equals_the_per_round_loop(data, fault):
    c = acfg(fault, cohort_participation=0.8, staleness_buffer=3,
             telemetry=True, staleness_discount=0.5)
    h_eng = _run(c, data)
    assert same_history(h_eng, _run(c, data, use_engine=False))
    assert all(torch.isfinite(v).all() for v in h_eng["params"].values())


def _counts(c, data):
    fed = federation(c, data)
    run_federated_training(model(), fed, c, LR)
    out = {"stale_buffered": 0, "stale_folded": 0, "stale_expired": 0,
           "cohort_resample": 0}
    for e in fed.server.audit.entries:
        if e["kind"] in out:
            out[e["kind"]] += e["data"].get("count", 1)
    return out, fed


def test_stragglers_are_buffered_then_folded(data):
    c = acfg(FaultConfig("straggler", rate=0.4, delay=1),
             staleness_buffer=4, telemetry=True, rounds=6)
    n, fed = _counts(c, data)
    assert n["stale_buffered"] > 0 and n["stale_folded"] > 0
    assert n["stale_folded"] <= n["stale_buffered"]
    assert n["cohort_resample"] == c.rounds
    assert fed.server.audit.verify()


def test_stragglers_without_a_buffer_expire(data):
    c = acfg(FaultConfig("straggler", rate=0.4, delay=1), telemetry=True,
             cohort_participation=1.0)
    n, _ = _counts(c, data)
    assert n["stale_expired"] > 0
    assert n["stale_buffered"] == n["stale_folded"] == 0


def test_the_staleness_cap_expires_updates_over_the_delay(data):
    c = acfg(FaultConfig("straggler", rate=0.4, delay=2), staleness_buffer=4,
             staleness_cap=1, telemetry=True)
    n, _ = _counts(c, data)
    assert n["stale_expired"] > 0
    assert n["stale_buffered"] == n["stale_folded"] == 0


def test_intermittent_nan_is_screened_end_to_end(data):
    c = acfg(FaultConfig("intermittent", rate=0.3, mode="nan"),
             telemetry=True)
    fed = federation(c, data)
    eng = RoundEngine(model(), fed, c)
    p0 = model().init(torch.Generator().manual_seed(1), "cpu")
    lrs = torch.tensor([LR(i) for i in range(1, c.rounds + 1)])
    params, _, m, _ = eng.run_training(p0, torch.Generator().manual_seed(0),
                                       lrs)
    assert all(torch.isfinite(v).all() for v in params.values())
    assert m["_tel"]["nonfinite"].sum() > 0
    # a corrupted client is flagged, never kept
    assert (m["_tel"]["kept"] + m["_tel"]["tagged"]
            == m["_tel"]["cohort"]).all()


def test_a_byzantine_straggler_is_scored_when_it_lands(data):
    """Every client straggles in round 1 (rate 1, delay 1) and lands in
    round 2: round 2's logs hold the landed rows with their Byzantine
    bits, and the criterion tags the Byzantine ones among them."""
    c = acfg(FaultConfig("straggler", rate=1.0, delay=1),
             staleness_buffer=10, rounds=2, eval_every=1)
    fed = federation(c, data)
    eng = RoundEngine(model(), fed, c)
    p0 = model().init(torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(0)
    lrs = torch.tensor([LR(1), LR(2)])
    carry, logs1 = eng.run_segment(p0, g, lrs[:1])
    assert logs1["cohort"] == 0 and logs1["stale_buffered"] == 10
    carry, logs2 = eng.run_segment(carry, g, lrs[1:])
    assert logs2["stale_folded"] == 10
    landed = logs2["cand"][c.n_clients:]
    assert landed.all()
    byz = logs2["byz"][c.n_clients:]
    assert byz.sum() == c.f and not logs2["mask"][c.n_clients:][byz].any()


@pytest.mark.parametrize("fault", [
    FaultConfig("dropout", rate=0.3),
    FaultConfig("straggler", rate=0.3, delay=1),
    FaultConfig("intermittent", rate=0.3, mode="nan")],
    ids=lambda f: f.kind)
def test_async_rounds_match_the_reference_with_injected_draws(
        jax_guide_shim, fault):
    """Cohort 0.8, staleness buffer 3, 5 rounds of streaming diversefl
    under sign_flip: the reference engine against the port's engine fed
    the reference's minibatch indices, cohort chain, fault rows and sealed
    samples."""
    c = acfg(fault, cohort_participation=0.8, staleness_buffer=3,
             telemetry=True)
    jc = jax_cfg(c)
    jmodel, jfed = jax_federation(jc)
    fed = port_fed_like(c, jfed)
    draws = reference_draws(jc, jfed.data)
    scen = simulator.make_scenario(c, fed, cohort=reference_cohort(jc))
    jscen = jax_make_scenario(jc, jfed)
    jlrs = jax_lr_vector(jax_inv_sqrt_lr(0.05), c.rounds)
    lrs = torch.from_numpy(np.array(jlrs))
    jparams0 = jmodel.init(jax.random.PRNGKey(c.seed + 1))
    params0 = params_from_jax({k: np.asarray(v) for k, v in
                               jparams0.items()}, device="cpu")
    jeng = JaxRoundEngine(jmodel, jfed, jc)
    eng = RoundEngine(model(), fed, c)
    gen = torch.Generator().manual_seed(0)
    jtel, tel = jax_tel_fn(jc), make_round_telemetry_fn(c)

    jcarry, key, carry = jparams0, jax.random.PRNGKey(c.seed), params0
    for r in range(c.rounds):
        jcarry, key, jlogs = jeng.run_segment(jcarry, key, jlrs[r:r + 1],
                                              jscen)
        carry, logs = eng.run_segment(carry, gen, lrs[r:r + 1], scen,
                                      draws={k: v[r:r + 1]
                                             for k, v in draws.items()})
        for k in ("mask", "cand", "byz", "sel", "cohort", "stale_buffered",
                  "stale_folded", "stale_expired"):
            np.testing.assert_array_equal(logs[k].numpy(),
                                          np.asarray(jlogs[k]),
                                          err_msg=f"round {r + 1} {k}")
        jt, t = jtel(jlogs), tel(logs)
        assert set(jt) == set(t)
        for k in t:
            np.testing.assert_allclose(t[k].numpy(), np.asarray(jt[k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"round {r + 1} {k}")
        for k in carry[0]:
            np.testing.assert_allclose(carry[0][k].numpy(),
                                       np.asarray(jcarry[0][k]), atol=ATOL,
                                       rtol=RTOL, err_msg=f"round {r + 1}")
        if "u" in carry[1]:
            np.testing.assert_allclose(carry[1]["u"].numpy(),
                                       np.asarray(jcarry[1]["u"]),
                                       atol=ATOL, rtol=RTOL)

    jp, _, jm, _ = jeng.run_training(jparams0, jax.random.PRNGKey(c.seed),
                                     jlrs, jscen)
    pp, _, m, _ = eng.run_training(params0, gen, lrs, scen, draws=draws)
    host = simulator.host_sync(m)
    for k in ("acc", "mask_tpr", "mask_fpr"):
        np.testing.assert_array_equal(host[k], np.asarray(jm[k]), err_msg=k)
    for k in ("kept", "tagged", "cohort", "stale_buffered", "stale_folded",
              "stale_expired", "c1_pass", "c2_pass", "nonfinite"):
        np.testing.assert_array_equal(host["_tel"][k],
                                      np.asarray(jm["_tel"][k]), err_msg=k)
    for k in pp:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   atol=ATOL, rtol=RTOL)
