"""The port's baselines against the JAX reference, on the CPU: the
weighted-fold and median/trimmed-mean kernels' plain versions, the robust
aggregators of ``core/aggregators.py`` and the registry rules built on
them.

Inputs are made with numpy from a seed and handed to both packages; the
reference's resampling draw is passed to the port through its explicit
ids.  Tolerances are fp32 ones (rtol 1e-4, atol 1e-5) unless a comparison
is exact by construction: medians and order statistics pick input values,
so they match bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jax_agg
from repro.fl.server import AggregationContext as JaxContext
from repro.fl.server import aggregate as jax_aggregate
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core import aggregators as agg
from repro_torch.kernels import _build, ops
from repro_torch.kernels.masked_agg import (masked_agg_update_cuda,
                                            masked_agg_update_plain)
from repro_torch.kernels.robust_agg import (MAX_CLIENTS, robust_agg_cuda,
                                            robust_agg_plain)
from repro_torch.fl.server import AggregationContext, aggregate

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _updates(n, d, seed=0, ties=False):
    """(N, D) updates.  With ``ties``: two clients send the same-value
    attack's constant rows, two more send one benign client's update, and
    a block of columns is constant, so order statistics and distances to
    the median have exact ties."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, d)).astype(np.float32)
    if ties:
        u[1] = u[-1] = 3.0
        u[2] = u[3] = u[0]
        u[:, :7] = 0.5
    return u


def _separated(n=9, d=40, seed=4):
    """Well-separated updates: benign rows around a common direction at
    distinct spreads, and two far outliers, so Krum's scores have no near
    ties."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=d)
    u = base + (0.1 + 0.05 * np.arange(n))[:, None] * rng.normal(size=(n, d))
    u[[2, 6]] = -5.0 * base + rng.normal(size=(2, d))
    return u.astype(np.float32)


# ----------------------------------------------------------------------
# kernels: plain versions against the reference's oracles and ops
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 300), (23, 1001), (1, 257)])
def test_masked_agg_update_plain_matches_reference(shape):
    n, d = shape
    rng = np.random.default_rng(1)
    u = _updates(n, d, seed=2)
    w = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
    acc = rng.normal(size=d).astype(np.float32)
    got = masked_agg_update_plain(_t(u), _t(w), _t(acc))
    _close(got, jax_ops.masked_agg_update(jnp.asarray(u), jnp.asarray(w),
                                          jnp.asarray(acc)))
    # the un-normalised Eq. 6 oracle: ref divides by max(Σw, 1)
    unnorm = np.asarray(jax_ref.masked_agg_ref(jnp.asarray(u),
                                               jnp.asarray(w))) \
        * max(float(w.sum()), 1.0)
    _close(got, acc + unnorm)
    # all-zero weights return acc exactly, and acc is not modified
    acc_t = _t(acc)
    zero = masked_agg_update_plain(_t(u), torch.zeros(n), acc_t)
    assert torch.equal(zero, acc_t) and zero is not acc_t
    np.testing.assert_array_equal(acc_t.numpy(), acc)


@pytest.mark.parametrize("f", [0, 2, 5])
@pytest.mark.parametrize("n,ties", [(23, False), (24, False), (23, True),
                                    (12, True), (7, False)])
def test_robust_agg_plain_matches_reference(n, ties, f):
    u = _updates(n, 300, seed=n + f, ties=ties)
    med, trim = robust_agg_plain(_t(u), f)
    # a median picks (or averages two) input values: exact
    np.testing.assert_array_equal(med.numpy(),
                                  np.asarray(jax_ref.median_ref(u)))
    _close(trim, jax_ref.trimmed_ref(jnp.asarray(u), f))


@pytest.mark.parametrize("n,f,ties", [(7, 2, True), (12, 5, False),
                                      (12, 0, True)])
def test_robust_agg_plain_matches_the_interpret_mode_kernel(n, f, ties):
    """The Pallas kernel itself (interpret mode; its odd-even network
    compiles slowly, so at small N), over two column blocks and a ragged
    tail."""
    u = _updates(n, 700, seed=3, ties=ties)
    med, trim = robust_agg_plain(_t(u), f)
    jmed, jtrim = jax_ops.robust_aggregate(jnp.asarray(u), f, chunk=512)
    np.testing.assert_array_equal(med.numpy(), np.asarray(jmed))
    _close(trim, jtrim)


def test_ops_send_cpu_tensors_to_the_new_plain_versions():
    u = _t(_updates(6, 130))
    w = torch.linspace(0.0, 1.0, 6)
    acc = torch.ones(130)
    ops.reset_launch_counts()
    assert torch.equal(ops.masked_agg_update(u, w, acc),
                       masked_agg_update_plain(u, w, acc))
    for a, b in zip(ops.robust_aggregate(u, 2), robust_agg_plain(u, 2)):
        assert torch.equal(a, b)
    assert set(ops.launch_counts()) == {"similarity_stats",
                                        "masked_aggregate",
                                        "masked_agg_update",
                                        "robust_aggregate",
                                        "dequant_fold_update",
                                        "flash_attention",
                                        "mamba_scan",
                                        "client_step_rows"}
    assert not any(ops.launch_counts().values())
    with pytest.raises(ValueError, match="unsupported device"):
        ops.robust_aggregate(torch.empty((2, 8), device="meta"))


def test_robust_kernel_refuses_more_than_64_clients_before_building(
        monkeypatch):
    """The CUDA route raises a named error above N = 64 before it builds
    or launches anything: there is no fallback."""
    def no_build(*a, **k):
        raise AssertionError("the kernel must not be built")
    monkeypatch.setattr(_build, "entry_point", no_build)
    monkeypatch.setattr(ops, "_route", lambda t, name: True)
    with pytest.raises(ValueError, match="1 to 64 clients, got N = 65"):
        ops.robust_aggregate(torch.zeros((MAX_CLIENTS + 1, 16)), 5)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ops.robust_aggregate(torch.zeros((MAX_CLIENTS, 16)), 5)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        masked_agg_update_cuda(torch.zeros((3, 16)), torch.ones(3),
                               torch.zeros(16))
    assert robust_agg_cuda.launches == 0
    assert masked_agg_update_cuda.launches == 0


# ----------------------------------------------------------------------
# core/aggregators.py against repro.core.aggregators
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [9, 10])
def test_median_matches_the_reference(n):
    """Odd N picks the middle value, even N averages the two middle ones
    (torch.median would return the lower)."""
    u = _updates(n, 200, seed=5, ties=True)
    np.testing.assert_array_equal(agg.median(_t(u)).numpy(),
                                  np.asarray(jax_agg.median(jnp.asarray(u))))


@pytest.mark.parametrize("mode", ["beta", "near_median"])
@pytest.mark.parametrize("n,f", [(11, 2), (10, 3), (5, 3)])
def test_trimmed_mean_matches_the_reference(mode, n, f):
    """Ties in distance to the median (the same-value rows) keep the
    lower client index in both packages: a stable argsort."""
    u = _updates(n, 150, seed=6, ties=True)
    _close(agg.trimmed_mean(_t(u), f, mode),
           jax_agg.trimmed_mean(jnp.asarray(u), f, mode))


def test_krum_scores_and_krum_match_the_reference():
    u = _separated()
    for active in (None, np.array([1, 1, 0, 1, 1, 0, 1, 1, 1], bool)):
        got = agg.krum_scores(_t(u), 2,
                              None if active is None else _t(active))
        want = jax_agg.krum_scores(jnp.asarray(u), 2,
                                   None if active is None
                                   else jnp.asarray(active))
        _close(got, want, rtol=1e-5, atol=1e-3)
    pick = int(torch.argmin(agg.krum_scores(_t(u), 2)))
    assert pick not in (2, 6)                    # the outliers are not picked
    np.testing.assert_array_equal(agg.krum(_t(u), 2).numpy(),
                                  np.asarray(jax_agg.krum(jnp.asarray(u), 2)))


@pytest.mark.parametrize("f", [1, 2])
def test_bulyan_matches_the_reference(f):
    u = _separated(n=11, d=60, seed=7)
    _close(agg.bulyan(_t(u), f), jax_agg.bulyan(jnp.asarray(u), f))


def _jax_resample_ids(key, n, s_r):
    ids = jnp.tile(jnp.arange(n), s_r)
    return np.asarray(jax.random.permutation(key, ids)[: n * s_r]
                      .reshape(n, s_r))


@pytest.mark.parametrize("s_r", [2, 3])
def test_resampling_matches_the_reference_with_its_ids(s_r):
    u = _updates(9, 120, seed=8)
    key = jax.random.PRNGKey(3)
    want = jax_agg.resampling(jnp.asarray(u), key, s_r)
    got = agg.resampling(_t(u), s_r, ids=_t(_jax_resample_ids(key, 9, s_r)))
    _close(got, want)
    # a generator draw uses every client exactly s_r times
    ids = agg.resample_ids(9, s_r, torch.Generator().manual_seed(0))
    assert ids.shape == (9, s_r)
    assert torch.equal(torch.bincount(ids.flatten(), minlength=9),
                       torch.full((9,), s_r))
    with pytest.raises(ValueError, match="resample ids"):
        agg.resampling(_t(u), s_r, ids=ids[:, :1])


def test_fltrust_matches_the_reference():
    rng = np.random.default_rng(9)
    u = _updates(8, 90, seed=10)
    root = (u[:3].mean(0) + 0.1 * rng.normal(size=90)).astype(np.float32)
    u[5] = -u[1]                                   # a negative trust score
    ts, a = agg.fltrust_weights(_t(u), _t(root))
    assert float(ts[5]) == 0.0 and float(ts.max()) > 0.0
    got, _ = aggregate("fltrust", _t(u),
                       AggregationContext(root_update=_t(root)))
    _close(got, jax_agg.fltrust(jnp.asarray(u), jnp.asarray(root)))


# ----------------------------------------------------------------------
# the registry's rules against the reference registry
# ----------------------------------------------------------------------

RULES = ["median", "trimmed_mean", "krum", "bulyan", "resampling"]


@pytest.mark.parametrize("name", RULES)
def test_robust_registry_rules_match_the_reference(name):
    u = _separated(n=11, d=70, seed=11)
    u[4] = u[7]                                    # an exact tie
    key = jax.random.PRNGKey(5)
    want, jlogs = jax_aggregate(name, jnp.asarray(u), JaxContext(
        key=key, f=2, resample_s=2))
    got, tlogs = aggregate(name, _t(u), AggregationContext(
        f=2, resample_s=2, resample_ids=_t(_jax_resample_ids(key, 11, 2))))
    _close(got, want)
    assert set(tlogs) == set(jlogs) == set()


@pytest.mark.parametrize("use_kernel_agg", [False, True])
def test_fltrust_rule_matches_both_reference_forms(use_kernel_agg):
    """The port's one fltrust body (trust weights, the weighted fold, one
    division) against the reference's plain fold and its Pallas
    weighted-fold form (interpret mode)."""
    rng = np.random.default_rng(12)
    u = _updates(10, 130, seed=13)
    u[[1, 6]] *= -1.0
    root = (u[[0, 2, 3]].mean(0)
            + 0.05 * rng.normal(size=130)).astype(np.float32)
    want, _ = jax_aggregate("fltrust", jnp.asarray(u), JaxContext(
        root_update=jnp.asarray(root), use_kernel_agg=use_kernel_agg))
    got, logs = aggregate("fltrust", _t(u),
                          AggregationContext(root_update=_t(root)))
    _close(got, want)
    assert logs == {}
