"""The zoo's two kernels in the port against the JAX reference, on the CPU.

* ``flash_attention_plain`` (the CUDA kernel's plain version) against
  ``repro.kernels.ref.flash_attention_ref`` and the interpret-mode Pallas
  op ``ops.flash_attention_bhsd``: ``tests/test_kernels.py``'s shapes, head
  dim 80 (h2o-danube), a softcap, ragged S and bf16.
* ``mamba_scan_plain`` against ``ref.mamba_scan_ref`` and the
  interpret-mode ``ops.mamba_scan_raw``, ragged S and d_inner included,
  and its final state against a float64 loop.
* The layout adapters ``ops.flash_attention`` (B, S, H, dh) and
  ``ops.mamba_scan`` (the model's coefficients) against the reference's.
* What the bf16 tensor-core kernel is held to on the card: one bf16 step
  of the plain version (atol 1e-5, rtol 2^-7) admits an emulation of its
  split p·v, the ``mask_probe_inputs`` probe rejects a window one key off,
  and ``check_bf16_operands`` refuses a layout ``cp.async`` cannot take.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against these plain versions there).  The reference's Mamba kernel calls
``pl.store``, which JAX 0.9 no longer has: the tests that reach it add it
back through a function-scoped fixture (see :func:`pallas_store`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import init as jax_init
from repro_torch import configs
from repro_torch.convert import tree_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (NEG_INF,
                                                 check_bf16_operands,
                                                 flash_attention_cuda,
                                                 flash_attention_plain,
                                                 mask_probe_inputs)
from repro_torch.kernels.mamba_scan import mamba_scan_cuda, mamba_scan_plain


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_store(monkeypatch):
    """Give ``jax.experimental.pallas`` back the ``store`` that
    ``repro/kernels/mamba_scan.py:38`` calls (JAX 0.9 dropped it), for one
    test only.  The jit caches are cleared afterwards, so no program
    traced with it serves a later test: the reference's own mamba tests
    in ``tests/test_kernels.py`` keep failing as on the seed, on every
    worker."""
    import jax.experimental.pallas as pl
    monkeypatch.setattr(pl, "store",
                        lambda ref, idx, val: ref.__setitem__(idx, val),
                        raising=False)
    yield
    jax.clear_caches()


def _qkv(B, H, K, S, dh, seed, qscale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, S, dh)) * qscale).astype(np.float32)
    k = rng.normal(size=(B, K, S, dh)).astype(np.float32)
    v = rng.normal(size=(B, K, S, dh)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------

FLASH_CASES = [
    # tests/test_kernels.py's shapes: (B, H, K, S, dh, window, softcap)
    (1, 2, 2, 128, 32, None, None),
    (2, 4, 2, 192, 64, None, None),          # GQA
    (1, 4, 1, 256, 64, None, None),          # MQA
    (2, 2, 2, 256, 32, 64, None),            # sliding window
    (1, 2, 2, 100, 32, 32, None),            # ragged S with a window
    # beyond them: h2o-danube's head dim, a softcap, ragged S
    (1, 4, 2, 96, 80, 40, None),
    (1, 4, 1, 77, 32, None, 30.0),
    (2, 2, 1, 133, 48, 50, 20.0),
]


@pytest.mark.parametrize("B,H,K,S,dh,window,softcap", FLASH_CASES)
def test_flash_plain_matches_reference(B, H, K, S, dh, window, softcap):
    """fp32: the plain version against the reference formula (same op
    order: 1e-5) and against the interpret-mode Pallas kernel (online
    softmax, other order: 2e-4 / 2e-5 as tests/test_kernels.py)."""
    q, k, v = _qkv(B, H, K, S, dh, S + dh, 6.0 if softcap else 1.0)
    got = flash_attention_plain(*_t(q, k, v), window, softcap).numpy()
    want = jax_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), window=window,
                                       softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    pallas = jax_ops.flash_attention_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        softcap=softcap, bq=32, bk=32)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-4, atol=2e-5)
    # the port's public op routes a CPU tensor to the plain version
    routed = ops.flash_attention_bhsd(*_t(q, k, v), window, softcap)
    np.testing.assert_array_equal(routed.numpy(), got)


@pytest.mark.parametrize("window", [None, 24])
def test_flash_plain_bf16(window):
    """bf16 in, bf16 out: the plain version and the reference formula
    both compute in fp32 and round once, within one bf16 step (5e-2 as
    tests/test_kernels.py holds the Pallas kernel)."""
    q, k, v = _qkv(1, 4, 2, 72, 64, 7)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    got = flash_attention_plain(tq, tk, tv, window)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (tq, tk, tv))
    want = jax_ref.flash_attention_ref(jq, jk, jv, window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_flash_plain_chunks_rows_exactly(monkeypatch):
    """Query rows in chunks give the bits of one pass over all rows."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _t(*_qkv(1, 2, 1, 90, 16, 3))
    whole = flash_attention_plain(q, k, v, 20, None)
    monkeypatch.setattr(fa, "PLAIN_Q_CHUNK", 16)
    np.testing.assert_array_equal(flash_attention_plain(q, k, v, 20,
                                                        None).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("window,softcap", [(None, None), (16, None),
                                            (None, 25.0)])
def test_flash_adapter_matches_reference(window, softcap):
    """The (B, S, H, dh) adapter against the reference's
    ``ops.flash_attention`` (interpret mode)."""
    rng = np.random.default_rng(11)
    B, S, H, K, dh = 2, 50, 4, 2, 32
    q = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, K, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, K, dh)).astype(np.float32)
    got = ops.flash_attention(*_t(q, k, v), window, softcap)
    assert tuple(got.shape) == (B, S, H, dh) and got.is_contiguous()
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=window,
                                   softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_flash_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = _t(*_qkv(1, 2, 1, 8, 16, 0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="divide"):
        flash_attention_cuda(q, torch.zeros(1, 3, 8, 16), v)


def _bf16_kernel_rounding(q, k, v, window, softcap, bk=64, split=True):
    """The bf16 kernel's arithmetic in PyTorch: an online softmax over
    tiles of ``bk`` keys in fp32, every tile from the first key, masked
    scores at NEG_INF (so a fully masked first tile counts 1 per key until
    the first real score wipes it), l summing the fp32 p, the output
    rounded to bf16.  The p·v operand: with ``split``, p_hi = bf16(p) plus
    p_lo = bf16(p - p_hi), as the kernel issues it (two products into one
    fp32 accumulator); without, one bf16(p), the single rounding the
    kernel took before the split."""
    B, H, Sq, dh = q.shape
    K, Sk = k.shape[1], k.shape[2]
    g = H // K
    qf = q.float().reshape(B, K, g, Sq, dh)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) / dh ** 0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    mask = kp <= qp
    if window is not None:
        mask &= kp > qp - window
    s = torch.where(mask, s, NEG_INF)
    m = torch.full((B, K, g, Sq, 1), NEG_INF)
    l = torch.zeros((B, K, g, Sq, 1))
    acc = torch.zeros((B, K, g, Sq, dh))
    for k0 in range(0, Sk, bk):
        st = s[..., k0:k0 + bk]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        ph = p.to(torch.bfloat16).float()
        vt = vf[:, :, k0:k0 + bk]
        pv = torch.einsum("bkgqs,bksd->bkgqd", ph, vt)
        if split:
            pl = (p - ph).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bkgqs,bksd->bkgqd", pl, vt)
        acc = acc * alpha + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.reshape(B, H, Sq, dh).to(torch.bfloat16)


def _bf16_bar(out, ref):
    """chip_smoke's bar for the bf16 kernel against its plain version:
    atol 1e-5, rtol 2^-7, one bf16 step."""
    return (out.float() - ref.float()).abs() \
        <= 1e-5 + 2.0 ** -7 * ref.float().abs()


@pytest.mark.parametrize("window,softcap", [(None, None), (48, None),
                                            (None, 30.0), (40, 20.0)])
@pytest.mark.parametrize("B,H,K,S,dh", [(1, 4, 2, 200, 80),
                                        (2, 2, 1, 150, 64)])
def test_bf16_error_bound_admits_kernel_rounding(B, H, K, S, dh, window,
                                                 softcap):
    """The card's bound for the bf16 kernel, one bf16 step of the plain
    version, admits an emulation of its arithmetic (p split into two bf16
    halves for p·v), and the split is what makes it fit: one bf16
    rounding of p lies farther from the plain version."""
    q, k, v = _qkv(B, H, K, S, dh, S + dh + 1, 6.0 if softcap else 1.0)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    ref = flash_attention_plain(tq, tk, tv, window, softcap)
    emu = _bf16_kernel_rounding(tq, tk, tv, window, softcap)
    ok = _bf16_bar(emu, ref)
    err = (emu.float() - ref.float()).abs().max().item()
    assert bool(ok.all()), err
    single = _bf16_kernel_rounding(tq, tk, tv, window, softcap, split=False)
    assert (single.float() - ref.float()).abs().max().item() > err


def _probe_bar(out, ref):
    """chip_smoke's bar for the mask probe: atol 1e-5, rtol 2^-7."""
    return bool(_bf16_bar(out, ref).all())


@pytest.mark.parametrize("S,dh,window", [(200, 16, 50), (300, 32, 129),
                                         (2000, 72, 700)])
def test_mask_probe_rejects_a_window_off_by_one(S, dh, window):
    """q = 0 makes every admitted key count exactly: the probe passes the
    plain version against itself and rejects one whose window admits one
    key more or one less."""
    q, k, v = mask_probe_inputs(1, 2, 1, S, dh)
    assert q.dtype == torch.bfloat16 and not bool(q.any())
    assert torch.equal(v.float().sum(-1), torch.ones((1, 1, S)))
    ref = flash_attention_plain(q, k, v, window)
    # a row's columns split its admitted keys: they sum to 1
    np.testing.assert_allclose(ref.float().sum(-1).numpy(), 1.0, rtol=2e-2)
    assert _probe_bar(flash_attention_plain(q, k, v, window), ref)
    for off in (window - 1, window + 1):
        assert not _probe_bar(flash_attention_plain(q, k, v, off), ref)


def test_mask_probe_holds_the_softcap_and_causal_shapes():
    """Under a softcap tanh(0) = 0, so the probe's output is the capless
    one; without a window, a diagonal that admits no key of its own row
    (the row before's output) fails the bar."""
    q, k, v = mask_probe_inputs(1, 4, 2, 160, 32)
    ref = flash_attention_plain(q, k, v)
    assert torch.equal(flash_attention_plain(q, k, v, None, 30.0), ref)
    shifted = torch.cat([ref[:, :, :1], ref[:, :, :-1]], dim=2)
    assert not _probe_bar(shifted, ref)


def test_bf16_layout_checks_raise_before_launch():
    """The bf16 kernel's layout is checked on the host, before any launch:
    dh a multiple of 8, a 16-byte-aligned base, strides in multiples of 8
    elements.  A well-laid-out set passes."""
    good = torch.zeros((1, 2, 10, 16), dtype=torch.bfloat16)
    check_bf16_operands(good, good, good, good)
    # the model's (B, S, H, dh) tensors, seen as (B, H, S, dh)
    check_bf16_operands(torch.zeros((2, 10, 4, 80),
                                    dtype=torch.bfloat16).transpose(1, 2))
    with pytest.raises(ValueError, match="multiple of 8, got 12"):
        check_bf16_operands(torch.zeros((1, 2, 10, 12),
                                        dtype=torch.bfloat16))
    flat = torch.zeros(2 * 10 * 16 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k must start on 16 bytes"):
        check_bf16_operands(good, flat[1:1 + 320].view(1, 2, 10, 16))
    with pytest.raises(ValueError, match="v needs strides"):
        check_bf16_operands(good, good, torch.zeros(
            (1, 2, 10, 20), dtype=torch.bfloat16)[..., :16])


# ----------------------------------------------------------------------
# mamba scan
# ----------------------------------------------------------------------

def _scan_inputs(B, S, di, n, seed):
    rng = np.random.default_rng(seed)
    da = np.exp(-np.abs(rng.normal(size=(B, S, di, n)))).astype(np.float32)
    dbx = rng.normal(size=(B, S, di, n)).astype(np.float32)
    c = rng.normal(size=(B, S, n)).astype(np.float32)
    return da, dbx, c


def _scan_f64(da, dbx, c):
    B, S, di, n = da.shape
    h = np.zeros((B, di, n))
    y = np.zeros((B, S, di))
    for t in range(S):
        h = da[:, t].astype(np.float64) * h + dbx[:, t]
        y[:, t] = np.einsum("bdn,bn->bd", h, c[:, t].astype(np.float64))
    return y, h


# (B, S, di, n, bs, bd): the reference kernel's tiles must divide S and di
SCAN_CASES = [
    (1, 48, 24, 8, 16, 8),
    (2, 96, 40, 16, 32, 40),
    (1, 37, 13, 16, 37, 13),          # ragged S and d_inner: one tile
    (2, 21, 6, 4, 21, 6),
]


@pytest.mark.parametrize("B,S,di,n,bs,bd", SCAN_CASES)
def test_mamba_scan_plain_matches_reference(pallas_store, B, S, di, n, bs,
                                            bd):
    """y against the reference's sequential oracle and the interpret-mode
    Pallas kernel (1e-5; the same recurrence in fp32), the final state
    against a float64 loop."""
    da, dbx, c = _scan_inputs(B, S, di, n, S * di)
    y, h = mamba_scan_plain(*_t(da, dbx, c))
    want = jax_ref.mamba_scan_ref(jnp.asarray(da), jnp.asarray(dbx),
                                  jnp.asarray(c))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    pallas = jax_ops.mamba_scan_raw(jnp.asarray(da), jnp.asarray(dbx),
                                    jnp.asarray(c), bs=bs, bd=bd)
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
    y64, h64 = _scan_f64(da, dbx, c)
    np.testing.assert_allclose(y.numpy(), y64, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), h64, rtol=1e-5, atol=1e-5)
    ry, rh = ops.mamba_scan_raw(*_t(da, dbx, c))
    np.testing.assert_array_equal(ry.numpy(), y.numpy())
    np.testing.assert_array_equal(rh.numpy(), h.numpy())


def test_mamba_scan_state_decays_across_the_sequence():
    """An impulse at t = 0 decays geometrically (the reference's
    test_mamba_scan_state_carries_across_chunks, on the plain version)."""
    B, S, di, n = 1, 128, 8, 4
    da = torch.full((B, S, di, n), 0.9)
    dbx = torch.zeros((B, S, di, n))
    dbx[:, 0] = 1.0
    y, h = mamba_scan_plain(da, dbx, torch.ones((B, S, n)))
    np.testing.assert_allclose(y[0, :, 0].numpy(), n * 0.9 ** np.arange(S),
                               rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.full((B, di, n), 0.9 ** 127),
                               rtol=1e-5)


def test_mamba_scan_adapter_matches_reference(pallas_store):
    """``ops.mamba_scan`` on the model's coefficients against the
    reference's adapter (interpret mode), on falcon-mamba SMOKE params."""
    cfg_j = dataclasses.replace(jconfigs.get("falcon-mamba-7b", smoke=True),
                                dtype="float32", param_dtype="float32")
    cfg = dataclasses.replace(configs.get("falcon-mamba-7b", smoke=True),
                              dtype="float32", param_dtype="float32")
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), cfg_j))
    pj = jax.tree.map(lambda x: x[0], params["groups"][0]["mamba"])
    xc = np.random.default_rng(5).normal(
        size=(2, 24, cfg.d_inner)).astype(np.float32)
    want = jax_ops.mamba_scan(jnp.asarray(xc), jax.tree.map(jnp.asarray, pj),
                              cfg_j)
    y, h = ops.mamba_scan(torch.from_numpy(xc), tree_from_jax(pj, "cpu"),
                          cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert tuple(h.shape) == (2, cfg.d_inner, cfg.ssm_state)


def test_mamba_cuda_wrapper_refuses_bad_input():
    da, dbx, c = _t(*_scan_inputs(1, 4, 3, 8, 0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mamba_scan_cuda(da, dbx, c)
    for n in (4, 17):             # built for the configs' 8 and 16 only
        other = torch.zeros((1, 4, 3, n))
        with pytest.raises(ValueError, match="state size"):
            mamba_scan_cuda(other, other, torch.zeros((1, 4, n)))


def test_ops_refuse_other_devices():
    """Neither a CUDA nor a CPU tensor: the route raises, nothing falls
    back."""
    m = torch.empty((1, 2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention_bhsd(m, m, m)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.mamba_scan_raw(m, m, torch.empty((1, 2, 8), device="meta"))
