"""The port's third slice as a whole, on the CPU: streaming rounds and the
compressed uplink on the 3-NN (hidden 16, D = 13,002), 23 clients, f = 5.

* With injected draws, the port's streaming rounds (f32 codec,
  ``client_chunk=8``) match the reference's streaming round body with its
  Pallas folds in interpret mode, round for round.
* The lossy codecs across frameworks, one round from identical params: a
  1e-7 difference in a client update can move an int8 value (or a bf16
  rounding) across a rounding boundary, so the payloads agree except for
  single steps at entries that lie on such a boundary, and the residuals
  and params agree up to those steps.
* The port's own contracts: streaming equals dense bit for bit for
  diversefl, oracle and mean under every codec and chunk; fltrust to fp
  tolerance; the sharded and two-tier associations; the gaussian
  attack's draws; the wire traffic in the history; the fallback of a
  non-associative rule; the reference's bars under every codec.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl.engine as jax_engine
import repro_torch.fl.simulator as simulator
from repro.core.attacks import AttackConfig as JaxAttackConfig
from repro.data import FederatedData as JaxFederatedData
from repro.data import partition_sorted_shards as jax_partition
from repro.fl import FLConfig as JaxFLConfig
from repro.fl import Federation as JaxFederation
from repro.fl.engine import make_round_body as jax_make_round_body
from repro.fl.small_models import mlp3 as jax_mlp3
from repro.optim import inv_sqrt_lr as jax_inv_sqrt_lr
from repro_torch.convert import params_from_jax
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import (FederatedData, make_mnist_like,
                              partition_sorted_shards)
from repro_torch.fl import (FLConfig, Federation, make_round_body, mlp3,
                            run_federated_training, softmax_regression)
from repro_torch.fl.streaming import NON_STREAMING
from repro_torch.optim import inv_sqrt_lr

N_CLIENTS, F, HIDDEN = 23, 5, 16
D = 784 * HIDDEN + HIDDEN + HIDDEN * HIDDEN + HIDDEN + HIDDEN * 10 + 10


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


def _numpy_mnist_like(n, seed):
    """MNIST-shaped class-template data, made with numpy for both packages."""
    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(1234).normal(size=(10, 784))
    y = rng.integers(0, 10, size=n)
    x = templates[y] + 0.5 * rng.normal(size=(n, 784))
    return x.reshape(n, 28, 28).astype(np.float32), y.astype(np.int32)


def _twin_federations(jcfg, cfg, n=920):
    """The reference's federation and the port's, on the same numpy data,
    the port holding the reference's sealed samples and root set."""
    x, y = _numpy_mnist_like(n, seed=0)
    tx, ty = _numpy_mnist_like(200, seed=9)
    jmodel = jax_mlp3(hidden=HIDDEN)
    jdata = JaxFederatedData.from_partitions(jax_partition(x, y, N_CLIENTS),
                                             10)
    key = jax.random.PRNGKey(2)
    jfed = JaxFederation.create(jmodel, jdata, jnp.asarray(tx),
                                jnp.asarray(ty), jcfg, key)
    n_total = N_CLIENTS * jdata.per_client
    root_idx = np.array(jax.random.choice(
        jax.random.split(key)[1], n_total,
        (max(1, int(jcfg.root_frac * n_total)),), replace=False))
    model = mlp3(hidden=HIDDEN)
    data = FederatedData.from_partitions(
        partition_sorted_shards(torch.from_numpy(x),
                                torch.from_numpy(y).long(), N_CLIENTS), 10)
    fed = Federation.create(model, data, torch.from_numpy(tx),
                            torch.from_numpy(ty).long(), cfg,
                            torch.Generator().manual_seed(0), device="cpu",
                            root_idx=torch.from_numpy(root_idx))
    for j in range(N_CLIENTS):
        sx, sy = jfed.server.enclave.unseal_samples(j)
        fed.server.ingest_samples(j, np.asarray(sx), np.asarray(sy))
    np.testing.assert_array_equal(fed.root_x.numpy(), np.asarray(jfed.root_x))
    return jmodel, jdata, jfed, model, fed


def _batch(draw, jdata, m):
    idx = draw.integers(0, jdata.per_client, size=(N_CLIENTS, m))
    rows = np.arange(N_CLIENTS)[:, None]
    return idx, (jnp.asarray(np.asarray(jdata.x)[rows, idx]),
                 jnp.asarray(np.asarray(jdata.y)[rows, idx]))


@pytest.mark.parametrize("aggregator", ["diversefl", "fltrust"])
def test_streaming_rounds_match_the_reference_with_injected_draws(
        jax_guide_shim, aggregator):
    """8 streaming rounds (f32 codec, 3 blocks of 8 clients, the last with
    one padding row) from the same minibatches, sealed samples and root
    set: the same masks, and params within fp32 tolerance (atol 1e-5,
    rtol 1e-4) every round.  The reference folds through its Pallas
    kernels in interpret mode (``use_kernel_agg``)."""
    rounds, m = 8, 20
    attack = "sign_flip"
    jcfg = JaxFLConfig(n_clients=N_CLIENTS, f=F, rounds=rounds,
                       aggregator=aggregator, l2=0.0005, batch_size=m,
                       attack=JaxAttackConfig(kind=attack), streaming=True,
                       client_chunk=8, use_kernel_agg=True,
                       use_kernel_stats=aggregator == "diversefl")
    cfg = FLConfig(n_clients=N_CLIENTS, f=F, rounds=rounds,
                   aggregator=aggregator, l2=0.0005, batch_size=m,
                   attack=AttackConfig(kind=attack), streaming=True,
                   client_chunk=8)
    jmodel, jdata, jfed, model, fed = _twin_federations(jcfg, cfg)
    jbody = jax_make_round_body(jmodel, jfed, jcfg, client_chunk=8)
    assert jbody.streaming
    jstep = jax.jit(lambda p, k, lr, b: jbody(p, k, lr, batch=b))
    step = make_round_body(model, fed, cfg)
    assert step.streaming and not step.lossy

    jparams = jmodel.init(jax.random.PRNGKey(1))
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             device="cpu")
    draw = np.random.default_rng(6)
    for r in range(1, rounds + 1):
        idx, batch = _batch(draw, jdata, m)
        jparams, jlogs = jstep(jparams, jax.random.PRNGKey(r),
                               jax_inv_sqrt_lr(0.05)(r), batch)
        with torch.no_grad():
            params, logs = step(params, inv_sqrt_lr(0.05)(r),
                                batch_idx=torch.from_numpy(idx))
        if aggregator == "diversefl":
            np.testing.assert_array_equal(logs["mask"].numpy(),
                                          np.asarray(jlogs["mask"]),
                                          err_msg=f"round {r}")
        for k in jparams:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(jparams[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"round {r} {k}")
    if aggregator == "diversefl":
        assert not logs["mask"][fed.byz_mask].any()


def _record(monkeypatch, module, store):
    """Wrap ``module.encode_with_feedback`` to keep its inputs and the
    encoded payload of every call."""
    inner = module.encode_with_feedback

    def recording(codec, u, resid):
        enc, dec, new = inner(codec, u, resid)
        store.append((u + resid, enc))
        return enc, dec, new
    monkeypatch.setattr(module, "encode_with_feedback", recording)


def _boundary_steps(name, v, v_ref, q, q_ref, scale):
    """The entries where the two payloads differ, checked to be single
    rounding steps at a rounding boundary that the two inputs straddle
    or nearly touch; returns the size of each admitted step."""
    v, v_ref = v.numpy(), np.asarray(v_ref)
    if name == "int8":
        q, q_ref = q.numpy().astype(np.int32), np.asarray(q_ref).astype(
            np.int32)
        step = np.repeat(scale.numpy(), 128, axis=-1)[:, :v.shape[1]]
        diff = q != q_ref
        assert (np.abs(q - q_ref)[diff] == 1).all()
        t = v / np.where(step > 0, step, 1.0)
        near = np.abs(t - np.floor(t) - 0.5) < \
            1e-4 + np.abs(v - v_ref) / np.where(step > 0, step, 1.0)
        assert near[diff].all(), "an int8 step away from a k + 1/2 boundary"
        return diff * step
    q = q.to(torch.float32).numpy()
    q_ref = np.asarray(q_ref.astype(jnp.float32))
    lo = (np.abs(v).view(np.int32) & ~0xFFFF).view(np.float32)
    ulp = (lo.view(np.int32) + 0x10000).view(np.float32) - lo
    diff = q != q_ref
    assert np.allclose(np.abs(q - q_ref)[diff], ulp[diff])
    t = (np.abs(v) - lo) / ulp
    near = np.abs(t - 0.5) < 1e-3 + np.abs(v - v_ref) / ulp
    assert near[diff].all(), "a bf16 step away from a rounding tie"
    return diff * ulp


@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_lossy_round_matches_the_reference_up_to_boundary_steps(
        jax_guide_shim, monkeypatch, name):
    """One dense diversefl round under the codec, from identical params and
    zero residuals, with the same minibatches and sealed samples.  The
    payloads agree except for single steps where an update sits on a
    rounding boundary; the masks agree; the residual planes agree except
    by those steps, and the params within tolerance plus the steps."""
    m = 20
    jcfg = JaxFLConfig(n_clients=N_CLIENTS, f=F, rounds=1,
                       aggregator="diversefl", l2=0.0005, batch_size=m,
                       attack=JaxAttackConfig(kind="sign_flip"),
                       compression=name)
    cfg = FLConfig(n_clients=N_CLIENTS, f=F, rounds=1, aggregator="diversefl",
                   l2=0.0005, batch_size=m,
                   attack=AttackConfig(kind="sign_flip"), compression=name)
    jmodel, jdata, jfed, model, fed = _twin_federations(jcfg, cfg)
    jbody = jax_make_round_body(jmodel, jfed, jcfg)
    body = make_round_body(model, fed, cfg)
    assert body.lossy and jbody.lossy
    got, want = [], []
    _record(monkeypatch, simulator, got)
    _record(monkeypatch, jax_engine, want)

    jparams = jmodel.init(jax.random.PRNGKey(1))
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             device="cpu")
    idx, batch = _batch(np.random.default_rng(6), jdata, m)
    (jparams, jresid), jlogs = jbody(
        (jparams, jnp.zeros((N_CLIENTS, D), jnp.float32)),
        jax.random.PRNGKey(1), jax_inv_sqrt_lr(0.05)(1), batch=batch)
    with torch.no_grad():
        (params, resid), logs = body(
            (params, torch.zeros((N_CLIENTS, D))), inv_sqrt_lr(0.05)(1),
            batch_idx=torch.from_numpy(idx))
    assert len(got) == len(want) == 1
    (v, enc), (v_ref, jenc) = got[0], want[0]
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-4,
                               atol=1e-7)
    if name == "int8":
        np.testing.assert_allclose(enc["scale"].numpy(),
                                   np.asarray(jenc["scale"]), rtol=1e-4)
    steps = _boundary_steps(name, v, v_ref, enc["q"], jenc["q"],
                            enc.get("scale"))
    assert (steps > 0).mean() < 1e-3
    np.testing.assert_array_equal(logs["mask"].numpy(),
                                  np.asarray(jlogs["mask"]))
    tol = 1e-4 * np.abs(v.numpy()) + 1e-7
    assert (np.abs(resid.numpy() - np.asarray(jresid))
            <= tol + steps * 1.0001).all()
    # a step moves one kept client's decoded value, and the mean by 1/|kept|
    kept = int(logs["mask"].sum())
    slack = steps.sum(0) / kept
    flat = np.concatenate([params[k].numpy().ravel() for k in sorted(params)])
    jflat = np.concatenate([np.asarray(jparams[k]).ravel()
                            for k in sorted(jparams)])
    assert (np.abs(flat - jflat) <= 1e-5 + 1e-4 * np.abs(jflat)
            + slack * 1.0001).all()


# ----------------------------------------------------------------------
# the port's own contracts
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_data():
    x, y = make_mnist_like(torch.Generator().manual_seed(0), 920)
    tx, ty = make_mnist_like(torch.Generator().manual_seed(9), 200)
    return (FederatedData.from_partitions(
        partition_sorted_shards(x, y, N_CLIENTS), 10), tx, ty)


def _train(small_data, rounds=4, attack="sign_flip", **kw):
    data, tx, ty = small_data
    model = mlp3(hidden=HIDDEN)
    cfg = FLConfig(n_clients=N_CLIENTS, f=F, rounds=rounds, batch_size=20,
                   l2=0.0005, eval_every=rounds,
                   attack=AttackConfig(kind=attack, sigma=10.0), **kw)
    fed = Federation.create(model, data, tx, ty, cfg, device="cpu")
    return run_federated_training(model, fed, cfg, inv_sqrt_lr(0.05))


def _assert_bitwise(a, b):
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for key in ("acc", "mask_tpr", "mask_fpr"):
        assert a[key] == b[key], key
    for x, y in zip(a["c1c2"], b["c1c2"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("aggregator", ["diversefl", "oracle", "mean"])
def test_streaming_equals_dense_bitwise(small_data, aggregator, codec, chunk):
    """Against the dense path (the dense lossy path under bf16/int8), both
    unchunked and at the same chunk."""
    stream = _train(small_data, aggregator=aggregator, compression=codec,
                    streaming=True, client_chunk=chunk)
    _assert_bitwise(stream, _train(small_data, aggregator=aggregator,
                                   compression=codec, client_chunk=chunk))
    _assert_bitwise(stream, _train(small_data, aggregator=aggregator,
                                   compression=codec))
    assert stream["streaming_fallback"] is None


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_streaming_fltrust_agrees_with_dense(small_data, codec):
    """Σ TSᵢ is summed per block: fp tolerance, not bits."""
    stream = _train(small_data, aggregator="fltrust", compression=codec,
                    streaming=True, client_chunk=8)
    dense = _train(small_data, aggregator="fltrust", compression=codec)
    for k in dense["params"]:
        np.testing.assert_allclose(stream["params"][k].numpy(),
                                   dense["params"][k].numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("chunk,shards,pods", [(8, 1, 1), (8, 3, None),
                                               (4, 2, 2)])
def test_sharded_and_two_tier_streaming(small_data, chunk, shards, pods):
    """From the same params (one round) the per-client criterion logs
    bitwise; over four rounds the masks' TPR/FPR equal and the params to
    rtol 1e-5, atol 1e-7 (``tests/test_compression.py``'s bar); (1, 1)
    bitwise."""
    kw = dict(aggregator="diversefl")
    skw = dict(streaming=True, client_chunk=chunk, stream_shards=shards,
               pods=pods)
    np.testing.assert_array_equal(
        _train(small_data, rounds=1, **kw, **skw)["c1c2"][-1],
        _train(small_data, rounds=1, **kw)["c1c2"][-1])
    dense = _train(small_data, **kw)
    stream = _train(small_data, **kw, **skw)
    assert stream["mask_tpr"] == dense["mask_tpr"]
    assert stream["mask_fpr"] == dense["mask_fpr"]
    for k in dense["params"]:
        np.testing.assert_allclose(stream["params"][k].numpy(),
                                   dense["params"][k].numpy(), rtol=1e-5,
                                   atol=1e-7)
    if (shards, pods) == (1, 1):
        _assert_bitwise(stream, dense)


def test_gaussian_draws_are_the_same_streaming_and_dense(small_data):
    """The noise is drawn a chunk of rows at a time on both paths, so the
    port's own generator gives both the same attack."""
    kw = dict(aggregator="diversefl", attack="gaussian", compression="int8",
              client_chunk=8)
    _assert_bitwise(_train(small_data, streaming=True, **kw),
                    _train(small_data, **kw))


def test_partial_participation_streams_bitwise(small_data):
    kw = dict(aggregator="diversefl", participation=0.6, compression="bf16")
    _assert_bitwise(_train(small_data, streaming=True, client_chunk=4, **kw),
                    _train(small_data, **kw))


def test_history_carries_the_wire_traffic(small_data):
    h = _train(small_data, rounds=1, aggregator="oracle", compression="int8",
               streaming=True, client_chunk=8)
    assert h["uplink_bytes_per_client"] == D + 4 * (-(-D // 128))
    assert h["uplink_bytes_per_round"] == N_CLIENTS * (D + 4 * (-(-D // 128)))
    assert h["dense_uplink_bytes_per_round"] == \
        h["downlink_bytes_per_round"] == 4 * D * N_CLIENTS
    assert h["uplink_reduction"] > 3.8
    f32 = _train(small_data, rounds=1, aggregator="oracle")
    assert f32["uplink_reduction"] == 1.0 and f32["streaming_fallback"] is None
    assert _train(small_data, rounds=1, aggregator="oracle",
                  compression="bf16")["uplink_reduction"] == 2.0


def test_non_associative_rule_falls_back_to_dense(small_data, caplog):
    with caplog.at_level(logging.WARNING):
        h = _train(small_data, rounds=2, aggregator="median",
                   compression="int8", streaming=True, client_chunk=8)
    assert h["streaming_fallback"] == NON_STREAMING["median"]
    assert "cannot stream" in caplog.text
    _assert_bitwise(h, _train(small_data, rounds=2, aggregator="median",
                              compression="int8", client_chunk=8))


def test_residuals_carry_the_wire_error(small_data):
    """The body's carry under a lossy codec: the residual plane is updated
    in place with exactly what each client's wire lost."""
    data, tx, ty = small_data
    model = mlp3(hidden=HIDDEN)
    cfg = FLConfig(n_clients=N_CLIENTS, f=F, batch_size=20, l2=0.0005,
                   aggregator="mean", compression="int8", streaming=True,
                   client_chunk=8)
    fed = Federation.create(model, data, tx, ty, cfg, device="cpu")
    body = make_round_body(model, fed, cfg)
    assert body.lossy and body.codec.name == "int8" and body.streaming
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    resid = torch.zeros((N_CLIENTS, D))
    with torch.no_grad():
        (p1, r1), _ = body((params, resid), 0.05,
                           torch.Generator().manual_seed(3))
    assert r1 is resid and resid.abs().sum() > 0
    # each residual is at most half a quantization step of its block
    assert (resid.abs().amax(1) < 0.05).all()


@pytest.fixture(scope="module")
def paper_data():
    x, y = make_mnist_like(torch.Generator().manual_seed(0), 4600)
    tx, ty = make_mnist_like(torch.Generator().manual_seed(9), 1000)
    return (FederatedData.from_partitions(
        partition_sorted_shards(x, y, N_CLIENTS), 10), tx, ty)


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_streaming_meets_the_reference_bars(paper_data, codec):
    """Over many rounds the bars, not the params: the paper's softmax
    regression configuration (``tests/test_torch_slice.py``), streamed in
    blocks of 8 under the codec: diversefl within 3 points of the
    oracle, and TPR >= 0.8."""
    data, tx, ty = paper_data
    model = softmax_regression()
    hist = {}
    for rule in ("diversefl", "oracle"):
        cfg = FLConfig(rounds=60, aggregator=rule, batch_size=50,
                       eval_every=60, attack=AttackConfig(kind="sign_flip"),
                       compression=codec, streaming=True, client_chunk=8)
        fed = Federation.create(model, data, tx, ty, cfg, device="cpu")
        hist[rule] = run_federated_training(model, fed, cfg,
                                            inv_sqrt_lr(0.05))
    dfl, orc = hist["diversefl"], hist["oracle"]
    assert dfl["final_acc"] >= orc["final_acc"] - 0.03, \
        (dfl["final_acc"], orc["final_acc"])
    assert dfl["mask_tpr"][-1] >= 0.8
    assert orc["final_acc"] > 0.8
