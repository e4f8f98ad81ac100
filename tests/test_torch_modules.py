"""Each module of the PyTorch port against its JAX counterpart, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference's random draws (JAX keys) are passed to the port through its
explicit-array seams.  Tolerances are fp32 ones (rtol 1e-5, atol 1e-6)
unless a comparison is exact by construction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jax_attacks
from repro.core import diversefl as jax_dfl
from repro.core.tee import Enclave as JaxEnclave
from repro.data import partition_sorted_shards as jax_partition
from repro.fl import metrics as jax_metrics
from repro.fl import telemetry as jax_telemetry
from repro.fl.server import SecureServer as JaxSecureServer
from repro.fl.server import aggregate as jax_aggregate
from repro.fl.server import AggregationContext as JaxContext
from repro.fl.small_models import softmax_regression as jax_softmax
from repro.optim import inv_sqrt_lr as jax_inv_sqrt_lr
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import attacks, diversefl
from repro_torch.core.aggregators import flatten_updates
from repro_torch.core.tee import Enclave
from repro_torch.data import (FederatedData, make_mnist_like,
                              partition_sorted_shards)
from repro_torch.fl import metrics, telemetry
from repro_torch.fl.server import (AggregationContext, SecureServer,
                                   aggregate, available_aggregators)
from repro_torch.fl.simulator import FLConfig
from repro_torch.fl.small_models import softmax_regression
from repro_torch.optim import constant_lr, inv_sqrt_lr

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def jax_guide_shim(monkeypatch):
    """The reference's guide cache calls ``jax.core.trace_state_clean``,
    which JAX 0.9 moved to ``jax._src.core``.  Point the old name at it for
    this test only."""
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _batch(n=40, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (n, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, size=lead + (n,)).astype(np.int32)
    return x, y


def _glorot_params(seed=3):
    """Reference glorot params (zero_init=False) and their port copy."""
    jp = jax_softmax(zero_init=False).init(jax.random.PRNGKey(seed))
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               device="cpu")


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------

def test_partition_sorted_shards_is_exactly_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(230, 4, 4)).astype(np.float32)
    y = rng.integers(0, 10, size=230)
    got = partition_sorted_shards(_t(x), _t(y), 7)
    want = jax_partition(x, y, 7)
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


def test_make_mnist_like_shapes_and_class_structure():
    x, y = make_mnist_like(torch.Generator().manual_seed(0), 300)
    assert x.shape == (300, 28, 28) and x.dtype == torch.float32
    assert y.shape == (300,) and int(y.min()) >= 0 and int(y.max()) <= 9
    # same class templates across calls: class means of two draws agree
    x2, y2 = make_mnist_like(torch.Generator().manual_seed(1), 300)
    m1 = x[y == 0].mean(0)
    m2 = x2[y2 == 0].mean(0)
    assert torch.corrcoef(torch.stack([m1.flatten(), m2.flatten()]))[0, 1] \
        > 0.9


def test_pipeline_draws_accept_explicit_indices():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 20, 2)).astype(np.float32)
    y = rng.integers(0, 5, size=(3, 20))
    data = FederatedData(_t(x), _t(y), 5)
    idx = rng.integers(0, 20, size=(3, 7))
    xb, yb = data.minibatch(7, idx=_t(idx))
    rows = np.arange(3)[:, None]
    np.testing.assert_array_equal(xb.numpy(), x[rows, idx])
    np.testing.assert_array_equal(yb.numpy(), y[rows, idx])
    s = data.sample_size(0.1)
    sidx = np.stack([rng.choice(20, s, replace=False) for _ in range(3)])
    gx, gy = data.enclave_samples(0.1, idx=_t(sidx))
    np.testing.assert_array_equal(gx.numpy(), x[rows, sidx])
    with pytest.raises(ValueError, match="minibatch idx"):
        data.minibatch(6, idx=_t(idx))
    # generator draws: the enclave sample is without replacement
    gx, _ = data.enclave_samples(0.5, torch.Generator().manual_seed(0))
    for j in range(3):
        assert len(np.unique(gx[j].numpy(), axis=0)) == 10


# ----------------------------------------------------------------------
# model, optimizer schedule, conversion
# ----------------------------------------------------------------------

def test_params_from_jax_roundtrip_with_glorot_init():
    jp, tp = _glorot_params()
    assert tp["w"].shape == (784, 10) and tp["b"].shape == (10,)
    for k in jp:
        np.testing.assert_array_equal(params_to_numpy(tp)[k], np.asarray(jp[k]))


@pytest.mark.parametrize("l2", [0.0, 0.0067])
def test_loss_and_grad_match_the_reference(l2):
    jp, tp = _glorot_params()
    x, y = _batch()
    jm, tm = jax_softmax(zero_init=False), softmax_regression(zero_init=False)
    want = jm.loss(jp, jnp.asarray(x), jnp.asarray(y), l2)
    got = tm.loss(tp, _t(x), _t(y).long(), l2)
    _close(got, want)
    jg = jax.grad(lambda p: jm.loss(p, jnp.asarray(x), jnp.asarray(y), l2))(jp)
    tg = tm.grad(tp, (_t(x), _t(y).long()), l2)
    for k in jg:
        _close(tg[k], jg[k])


def test_client_batched_loss_is_per_client_loss():
    jp, tp = _glorot_params()
    x, y = _batch(lead=(3,))
    tm = softmax_regression()
    batched = {k: torch.stack([v, 2 * v, -v]) for k, v in tp.items()}
    got = tm.loss(batched, _t(x), _t(y).long(), 0.01)
    for c in range(3):
        one = {k: v[c] for k, v in batched.items()}
        _close(got[c], tm.loss(one, _t(x[c]), _t(y[c]).long(), 0.01))


def test_schedules_match_the_reference():
    sched, jsched = inv_sqrt_lr(0.05), jax_inv_sqrt_lr(0.05)
    for i in range(1, 200):
        assert sched(i) == float(jsched(i))
    assert constant_lr(0.1)(7) == float(np.float32(0.1))


# ----------------------------------------------------------------------
# attacks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gaussian", "sign_flip", "same_value",
                                  "scale", "backdoor", "none"])
def test_attack_update_matches_the_reference(kind):
    u = np.random.default_rng(0).normal(size=(33,)).astype(np.float32)
    cfg_j = jax_attacks.AttackConfig(kind=kind, sigma=3.0, scale=5.0)
    cfg_t = attacks.AttackConfig(kind=kind, sigma=3.0, scale=5.0)
    key = jax.random.PRNGKey(4)
    want = jax_attacks.attack_update(jnp.asarray(u), kind, key, cfg_j)
    noise = _t(jax.random.normal(key, u.shape)) if kind == "gaussian" else None
    got = attacks.attack_update(_t(u), kind, cfg_t, noise=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flip_labels_and_backdoor_poison_match_the_reference():
    x, y = _batch(n=30, seed=5, lead=(2,))
    y[:, :12] = 3                            # plenty of source-class rows
    np.testing.assert_array_equal(
        attacks.flip_labels(_t(y), 10).numpy(),
        np.asarray(jax_attacks.flip_labels(jnp.asarray(y), 10)))
    cfg_j = jax_attacks.AttackConfig(kind="backdoor")
    cfg_t = attacks.AttackConfig(kind="backdoor")
    bx, by = attacks.poison_backdoor(_t(x), _t(y), cfg_t)
    for c in range(2):                       # reference: one client at a time
        wx, wy = jax_attacks.poison_backdoor(jnp.asarray(x[c]),
                                             jnp.asarray(y[c]), cfg_j)
        np.testing.assert_array_equal(bx[c].numpy(), np.asarray(wx))
        np.testing.assert_array_equal(by[c].numpy(), np.asarray(wy))


@pytest.mark.parametrize("n", [1, 2, 5, 10, 23, 40])
def test_byzantine_mask_matches_the_reference(n):
    """Exactly the reference's ids at the paper's N = 23; elsewhere they
    may differ only next to a position that is exactly k + 0.5, where the
    reference's float32 rounding direction depends on its compiler."""
    for f in range(n + 1):
        got = attacks.make_byzantine_mask(n, f).numpy()
        want = np.asarray(jax_attacks.make_byzantine_mask(n, f))
        if n == 23:
            np.testing.assert_array_equal(got, want, err_msg=f"{f}")
            continue
        ties = {(n - 1) * i // (f - 1) for i in range(f)
                if f > 1 and (2 * (n - 1) * i) % (f - 1) == 0
                and ((2 * (n - 1) * i) // (f - 1)) % 2 == 1}
        diff = set(np.nonzero(got != want)[0].tolist())
        assert diff <= ties | {t + 1 for t in ties}, (f, diff)
        assert got.sum() == want.sum() == f
    m = attacks.make_byzantine_mask(n, n // 2, torch.Generator().manual_seed(0))
    assert int(m.sum()) == n // 2


# ----------------------------------------------------------------------
# the criterion and Eq. 6
# ----------------------------------------------------------------------

def _stats_inputs(n=12, d=50, seed=6):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, d)).astype(np.float32)
    f = np.resize(np.array([1, -1, 2.5, 0.3, 1.2, 0.8], np.float32), n)
    U = (G * f[:, None] + 0.2 * rng.normal(size=(n, d))).astype(np.float32)
    G[-1] = 0.0                              # a dropped client's zero guide
    return U, G


def test_criterion_matches_the_reference():
    U, G = _stats_inputs()
    got = diversefl.similarity_stats_matrix(_t(U), _t(G))
    want = jax_dfl.similarity_stats_matrix(jnp.asarray(U), jnp.asarray(G))
    for a, b in zip(got, want):
        _close(a, b)
    cfg_t, cfg_j = diversefl.DiverseFLConfig(), jax_dfl.DiverseFLConfig()
    np.testing.assert_array_equal(
        diversefl.diversefl_mask(*got, cfg_t).numpy(),
        np.asarray(jax_dfl.diversefl_mask(*want, cfg_j)))
    tl = diversefl.criterion_logs(*got)
    jl = jax_dfl.criterion_logs(*want)
    assert set(tl) == set(jl)
    for k in jl:
        _close(tl[k], jl[k])


def test_guiding_update_matches_the_reference():
    jp, tp = _glorot_params()
    x, y = _batch(n=8, seed=7)
    jm, tm = jax_softmax(zero_init=False), softmax_regression(zero_init=False)
    jgrad = jax.grad(lambda p, b: jm.loss(p, b[0], b[1], 0.0067))
    want = jax_dfl.guiding_update(jp, (jnp.asarray(x), jnp.asarray(y)),
                                  jgrad, 0.05, E=2)
    got = diversefl.guiding_update(
        tp, (_t(x), _t(y).long()), lambda p, b: tm.grad(p, b, 0.0067), 0.05,
        E=2)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("mask_kind", ["random", "empty", "float"])
def test_masked_mean_flat_matches_the_reference(mask_kind):
    U, _ = _stats_inputs(n=9, d=77)
    rng = np.random.default_rng(8)
    mask = {"random": rng.random(9) > 0.5, "empty": np.zeros(9, bool),
            "float": (rng.random(9) > 0.5).astype(np.float32)}[mask_kind]
    s, n = diversefl.masked_sum_fold(_t(U), _t(mask))
    js, jn = jax_dfl.masked_sum_fold(jnp.asarray(U), jnp.asarray(mask))
    # the same strict left fold with exact 0/1 products: the same bits
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(n) == float(jn)
    np.testing.assert_array_equal(
        diversefl.masked_mean_flat(_t(U), _t(mask)).numpy(),
        np.asarray(jax_dfl.masked_mean_flat(jnp.asarray(U),
                                            jnp.asarray(mask))))


def test_flatten_updates_uses_the_reference_column_order():
    from repro.core.aggregators import flatten_updates as jax_flatten
    rng = np.random.default_rng(9)
    upd = {"w": rng.normal(size=(3, 4, 2)).astype(np.float32),
           "b": rng.normal(size=(3, 2)).astype(np.float32)}
    flat, unravel = flatten_updates({k: _t(v) for k, v in upd.items()})
    jflat, _ = jax_flatten({k: jnp.asarray(v) for k, v in upd.items()})
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = unravel(flat[1])
    for k in upd:
        np.testing.assert_array_equal(back[k].numpy(), upd[k][1])


# ----------------------------------------------------------------------
# registry and metrics
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["diversefl", "oracle", "mean"])
def test_registry_rules_match_the_reference(name):
    U, G = _stats_inputs()
    byz = np.zeros(12, bool)
    byz[[1, 7]] = True
    got, tlogs = aggregate(name, _t(U), AggregationContext(
        byz_mask=_t(byz), guides=_t(G)))
    want, jlogs = jax_aggregate(name, jnp.asarray(U), JaxContext(
        f=2, byz_mask=jnp.asarray(byz), guides=jnp.asarray(G)))
    _close(got, want)
    assert set(tlogs) == set(jlogs)
    if "mask" in jlogs:
        np.testing.assert_array_equal(tlogs["mask"].numpy(),
                                      np.asarray(jlogs["mask"]))
    assert available_aggregators() == ("diversefl", "oracle", "mean",
                                       "median", "trimmed_mean", "krum",
                                       "bulyan", "resampling", "fltrust")


def test_unknown_aggregator_is_a_named_error():
    with pytest.raises(ValueError, match="unknown aggregator"):
        FLConfig(aggregator="rsa")
    assert FLConfig(n_clients=23, participation=0.5).n_selected == 12


@pytest.mark.parametrize("case", ["mixed", "no_byz", "all_byz"])
def test_mask_rates_and_accuracy_match_the_reference(case):
    rng = np.random.default_rng(10)
    mask = rng.random(15) > 0.3
    byz = {"mixed": rng.random(15) > 0.6, "no_byz": np.zeros(15, bool),
           "all_byz": np.ones(15, bool)}[case]
    got = metrics.mask_rates(_t(mask), _t(byz))
    want = jax_metrics.mask_rates(jnp.asarray(mask), jnp.asarray(byz))
    for a, b in zip(got, want):
        assert float(a) == float(b)
    jp, tp = _glorot_params()
    x, y = _batch(n=64, seed=11)
    assert float(metrics.accuracy(softmax_regression(), tp, _t(x),
                                  _t(y).long())) == float(
        jax_metrics.accuracy(jax_softmax(), jp, jnp.asarray(x),
                             jnp.asarray(y)))


# ----------------------------------------------------------------------
# enclave, audit log, server
# ----------------------------------------------------------------------

def test_enclave_seals_the_reference_bytes_and_round_trips():
    x, y = _batch(n=4, seed=12)
    enc, jenc = Enclave(device="cpu"), JaxEnclave()
    for j in range(3):
        enc.seal_samples(j, x + j, y)
        jenc.seal_samples(j, x + j, y)
        assert enc._store[j] == jenc._store[j]
    ux, uy = enc.unseal_samples(1)
    np.testing.assert_array_equal(ux.numpy(), x + 1)
    np.testing.assert_array_equal(uy.numpy(), y)
    assert uy.dtype == torch.int64 and enc.seal_version == jenc.seal_version
    q = enc.attest(5)
    assert Enclave.verify_quote(q, "diversefl-enclave-v1", 5)
    assert not Enclave.verify_quote(q, "evil", 5)
    # EPC paging: one event per 4 KB page spilled past the budget
    small, jsmall = Enclave(epc_bytes=4096, device="cpu"), \
        JaxEnclave(epc_bytes=4096)
    for j in range(4):
        small.seal_samples(j, x, y)
        jsmall.seal_samples(j, x, y)
    assert small.paging_events == jsmall.paging_events > 0


def test_audit_chain_matches_the_reference_and_detects_tampering():
    log, jlog = telemetry.AuditLog(), jax_telemetry.AuditLog()
    for i in range(4):
        log.append("seal", client=i, version=i + 1)
        jlog.append("seal", client=i, version=i + 1)
    assert log.entries == jlog.entries and log.head == jlog.head
    assert telemetry.GENESIS == jax_telemetry.GENESIS
    assert log.verify() and jax_telemetry.verify_entries(log.entries)
    tampered = [dict(e) for e in log.entries]
    tampered[2] = {**tampered[2], "data": {"client": 9, "version": 3}}
    v = telemetry.verify_entries(tampered)
    assert not v and v.bad_index == 2
    swapped = [log.entries[1], log.entries[0]] + log.entries[2:]
    assert telemetry.verify_entries(swapped).bad_index == 0


def _ingest_both(server, jserver, n_clients=4, s=3, seed=13):
    x, y = _batch(n=n_clients * s, seed=seed)
    for j in range(n_clients):
        sl = slice(j * s, (j + 1) * s)
        server.ingest_samples(j, x[sl], y[sl])
        jserver.ingest_samples(j, x[sl], y[sl])


def test_compute_guides_matches_the_reference(jax_guide_shim):
    server, jserver = SecureServer(device="cpu"), JaxSecureServer()
    _ingest_both(server, jserver)
    jp, tp = _glorot_params()
    jm, tm = jax_softmax(zero_init=False), softmax_regression(zero_init=False)

    def jgrad(p, b):
        return jax.grad(lambda q: jm.loss(q, b[0], b[1], 0.0067))(p)
    sel = np.array([3, 0, 2])
    want = jserver.compute_guides(jp, jgrad, 0.05, E=2,
                                  select=jnp.asarray(sel), flat=True)
    got = server.compute_guides(tp, lambda p, b: tm.grad(p, b, 0.0067), 0.05,
                                E=2, select=_t(sel))
    _close(got, want)
    assert [e["kind"] for e in server.audit.entries] == \
        [e["kind"] for e in jserver.audit.entries]


def test_guide_cache_follows_the_sealed_store():
    server = SecureServer(device="cpu")
    with pytest.raises(RuntimeError, match="no sealed samples"):
        server.guide_batches()
    x, y = _batch(n=6, seed=14)
    for j in range(3):
        server.ingest_samples(j, x[2 * j:2 * j + 2], y[2 * j:2 * j + 2])
    gx, gy = server.guide_batches()
    assert server.guide_batches()[0] is gx          # cached
    ux, uy = server.enclave.unseal_samples(0)
    server.enclave.seal_samples(0, ux, 4 - uy)       # re-seal invalidates
    np.testing.assert_array_equal(server.guide_batches()[1][0].numpy(),
                                  4 - gy[0].numpy())
    server.drop_client(1)                            # rows stay id-aligned
    gx2, _ = server.guide_batches()
    assert gx2.shape == gx.shape and not gx2[1].any()
    np.testing.assert_array_equal(gx2[2].numpy(), gx[2].numpy())
    assert server.audit.verify()
    with pytest.raises(RuntimeError, match="attestation failed"):
        SecureServer(enclave=Enclave("evil-enclave", device="cpu"))
