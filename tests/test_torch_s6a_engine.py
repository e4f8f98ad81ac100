"""The zoo on the port's round engine against the reference's meshless
engine, on the CPU: the twin of the meshless run in
``tests/test_model_fl.py`` (zoo-tiny: 2 layers, d 32, vocab 64, seq 8; 4
clients, f = 1 under sign_flip, 4 rounds, streaming diversefl, eval every
2), in bf16 as configured and in an fp32 variant.  The port runs on the
reference's data, sealed samples, initial params and minibatch draws
(rebuilt from its key chain, ``tests/_torch_s5.py``).

Held: the eval rounds, the detection rates and accuracy exactly; at each
eval round every client's C1 sign and C2 pass/fail exactly, but at a
near-tie the port's own statistics show (|cos(z, g)| < 1e-2 for C1, C2
within 1e-2 of a bound); C2 = |C1·C2| to rtol 1e-2 in bf16, 1e-4 in fp32;
the final params to 1e-5 in fp32, and in bf16 within 3 steps of
2^-7 · max(|port|, |reference|, the leaf's largest update over the run).
The reference's XLA:CPU program fuses chains of bf16 operations and
rounds only at their end, the port rounds after each operation, so a
bf16 run parts by rounding noise: a near-zero parameter by a share of
its update, not of its own size (the worst entry measures 2.09 steps).
One host sync per run; the engine equal to the per-round loop and to
itself, bitwise; remat on equal to off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.fl.simulator as simulator
from _torch_s5 import reference_draws
from repro.core.attacks import AttackConfig as JaxAttackConfig
from repro.fl import FLConfig as JaxFLConfig
from repro.fl import zoo as jzoo
from repro.fl.engine import RoundEngine as JaxRoundEngine
from repro.models import ModelConfig as JaxModelConfig
from repro_torch.convert import zoo_params_from_jax
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import FederatedData
from repro_torch.kernels import ops
from repro_torch.fl import (Federation, FLConfig, RoundEngine,
                            make_zoo_federation, run_federated_training,
                            zoo_model)
from repro_torch.models import ModelConfig

TINY = dict(name="zoo-tiny", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, attn_direct_max=16)
SEQ, PER, N_TEST, LR = 8, 16, 32, 0.05
CFG = dict(n_clients=4, f=1, rounds=4, local_steps=1, batch_size=4, l2=0.0,
           aggregator="diversefl", streaming=True, stream_shards=1,
           eval_every=2, seed=0, compression="f32")
# dtype -> (C2 rtol, params tolerance: bf16 steps or absolute)
TOL = {"bfloat16": (1e-2, 3), "float32": (1e-4, 1e-5)}
NEAR_TIE = 1e-2         # |cos(z, g)| for C1; relative distance for C2


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


def _models(dtype):
    kw = dict(TINY, dtype=dtype, param_dtype=dtype)
    return (jzoo.zoo_model(JaxModelConfig(**kw), seq_len=SEQ),
            zoo_model(ModelConfig(**kw), seq_len=SEQ))


def _port_fed_like(model, cfg, jfed):
    """The port's federation on the reference's data, test split and
    sealed samples."""
    jd = jfed.data
    data = FederatedData(torch.from_numpy(np.asarray(jd.x)).long(),
                         torch.from_numpy(np.asarray(jd.y)).long(),
                         jd.n_classes)
    fed = Federation.create(model, data,
                            torch.from_numpy(np.asarray(jfed.test_x)).long(),
                            torch.from_numpy(np.asarray(jfed.test_y)).long(),
                            cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    for j in range(cfg.n_clients):
        sx, sy = jfed.server.enclave.unseal_samples(j)
        fed.server.ingest_samples(j, np.asarray(sx), np.asarray(sy))
    return fed


def _close_params(got, want, start, tol, dtype):
    for (k, g), w, w0 in zip(got.items(), jax.tree.leaves(want),
                             jax.tree.leaves(start)):
        g = g.float().numpy()
        w = np.asarray(w).astype(np.float32)
        if dtype == "bfloat16":
            upd = np.abs(w - np.asarray(w0).astype(np.float32)).max()
            step = np.maximum(np.maximum(np.abs(g), np.abs(w)), upd) \
                * 2.0 ** -7
            assert (np.abs(g - w) <= tol * step).all(), k
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)


def _criteria_agree(got, want, stats, dfl):
    """C1 signs and C2 pass/fail of the eval rows equal, or a near-tie in
    the port's (N, 3) statistics of that round; -> the C1 flips."""
    dot, zz, gg = (np.stack([s[:, i] for s in stats]) for i in range(3))
    cos = dot / np.sqrt(zz * gg)
    c1_tie = np.abs(cos) < NEAR_TIE
    assert ((np.sign(got) == np.sign(want)) | c1_tie).all(), cos
    c2 = np.abs(got)
    c2_tie = (np.abs(c2 - dfl.eps2) < NEAR_TIE * dfl.eps2) | \
        (np.abs(c2 - dfl.eps3) < NEAR_TIE * dfl.eps3)

    def passes(a):
        return (np.abs(a) > dfl.eps2) & (np.abs(a) < dfl.eps3)
    assert ((passes(got) == passes(want)) | c2_tie).all()
    return int((np.sign(got) != np.sign(want)).sum())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_zoo_engine_matches_the_reference(jax_guide_shim, monkeypatch,
                                          dtype):
    jm, tm = _models(dtype)
    jc = JaxFLConfig(**CFG, attack=JaxAttackConfig(kind="sign_flip"))
    c = FLConfig(**CFG, attack=AttackConfig(kind="sign_flip"))
    jfed = jzoo.make_zoo_federation(jm, jc, per_client=PER, n_test=N_TEST)
    fed = _port_fed_like(tm, c, jfed)
    draws = reference_draws(jc, jfed.data)
    jlrs = jnp.full((c.rounds,), LR, jnp.float32)
    jp0 = jm.init(jax.random.PRNGKey(c.seed + 1))
    p0 = zoo_params_from_jax(jax.tree.map(np.asarray, jp0), "cpu")
    stats = []                  # the port's statistics, one call a round
    real = ops.similarity_stats

    def spy(z, g):
        out = real(z, g)
        stats.append(out.numpy().copy())
        return out
    monkeypatch.setattr(ops, "similarity_stats", spy)

    jp, _, jmet, jrounds = JaxRoundEngine(jm, jfed, jc).run_training(
        jp0, jax.random.PRNGKey(c.seed), jlrs)
    eng = RoundEngine(tm, fed, c)
    p, _, met, rounds = eng.run_training(
        p0, torch.Generator().manual_seed(0),
        torch.from_numpy(np.asarray(jlrs)), draws=draws)
    assert rounds == list(jrounds) == [2, 4] and len(stats) == c.rounds
    host = simulator.host_sync(met)
    for k in ("acc", "mask_tpr", "mask_fpr"):
        np.testing.assert_array_equal(host[k], np.asarray(jmet[k]),
                                      err_msg=k)
    got_c, want_c = np.asarray(host["c1c2"]), np.asarray(jmet["c1c2"])
    flips = _criteria_agree(got_c, want_c, [stats[r - 1] for r in rounds],
                            c.dfl)
    assert flips == 0 or dtype == "bfloat16"
    ctol, ptol = TOL[dtype]
    np.testing.assert_allclose(np.abs(got_c), np.abs(want_c), rtol=ctol)
    assert {v.dtype for v in p.values()} == {getattr(torch, dtype)}
    _close_params(p, jp, jp0, ptol, dtype)


def test_zoo_run_makes_one_host_sync_and_equals_the_loop(monkeypatch):
    """run_federated_training on a zoo model: the engine syncs once and
    gives the per-round loop's history and params bit for bit, in bf16;
    a second engine run on the same federation repeats it."""
    _, tm = _models("bfloat16")
    c = FLConfig(**CFG, attack=AttackConfig(kind="sign_flip"))
    fed = make_zoo_federation(tm, c, torch.Generator().manual_seed(3),
                              per_client=PER, n_test=N_TEST, device="cpu")
    n = {"syncs": 0}
    real = simulator.host_sync

    def counted(tree):
        n["syncs"] += 1
        return real(tree)
    monkeypatch.setattr(simulator, "host_sync", counted)
    h = run_federated_training(tm, fed, c, lambda r: LR)
    assert n["syncs"] == 1
    h2 = run_federated_training(tm, fed, c, lambda r: LR, use_engine=False)
    assert n["syncs"] == 1 + 2                  # one a per eval point
    for a in (h2, run_federated_training(tm, fed, c, lambda r: LR)):
        assert a["acc"] == h["acc"] and a["mask_tpr"] == h["mask_tpr"]
        assert all(np.array_equal(x, y) for x, y in zip(a["c1c2"],
                                                        h["c1c2"]))
        for k in h["params"]:
            assert torch.equal(a["params"][k], h["params"][k]), k
    assert {v.dtype for v in h["params"].values()} == {torch.bfloat16}
    assert h["uplink_bytes_per_client"] == 4 * tm.param_count()


def test_remat_on_and_off_give_the_same_run():
    """cfg.remat checkpoints each group under grad: the same round, bit
    for bit, with it on and off."""
    hs = []
    c = FLConfig(**dict(CFG, rounds=2), attack=AttackConfig(kind="sign_flip"))
    for remat in (True, False):
        tm = zoo_model(dataclasses.replace(ModelConfig(**TINY), remat=remat),
                       seq_len=SEQ)
        fed = make_zoo_federation(tm, c, torch.Generator().manual_seed(3),
                                  per_client=PER, n_test=N_TEST,
                                  device="cpu")
        hs.append(run_federated_training(tm, fed, c, lambda r: LR))
    for k in hs[0]["params"]:
        assert torch.equal(hs[0]["params"][k], hs[1]["params"][k]), k
