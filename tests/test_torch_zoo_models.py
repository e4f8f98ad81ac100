"""The zoo's modules in the port against the JAX reference, on the CPU.

* Every config (FULL and SMOKE of all ten architectures) equals the
  reference's field by field; the parameter counts agree.
* ``init`` builds the reference's pytree for every config: the same
  nesting, shapes and dtypes (the fp32 MoE router and cross-layer
  ``xgate``, the encoder subtree).
* ``tree_from_jax`` / ``tree_to_numpy`` carry params across with their
  dtypes, bf16 included.
* Layers, rope, ``_sdpa``, ``_blockwise``, ``self_attention`` forward and
  decode (the ring buffer wrapping at SMOKE's window 16), and
  ``mamba_mixer`` forward (both routes) and decode, each against its JAX
  counterpart on the same (converted) params and inputs, in fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro_torch import configs, models
from repro_torch.convert import tree_from_jax, tree_to_numpy
from repro_torch.models import attention, layers, mamba

PORTED = ("h2o-danube-1.8b", "falcon-mamba-7b", "gemma-2b", "granite-20b",
          "minitron-8b", "whisper-medium", "deepseek-moe-16b",
          "kimi-k2-1t-a32b", "llama-3.2-vision-90b", "jamba-v0.1-52b")


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
    """``pl.store`` for the reference's Mamba kernel (JAX 0.9 dropped it),
    for one test; the jit caches are cleared afterwards so nothing traced
    with it outlives the test."""
    import jax.experimental.pallas as pl
    monkeypatch.setattr(pl, "store",
                        lambda ref, idx, val: ref.__setitem__(idx, val),
                        raising=False)
    yield
    jax.clear_caches()


def _fp32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                               **kw)


def _pair(arch, **kw):
    """(reference cfg, port cfg) of an arch's SMOKE config in fp32."""
    return (_fp32(jconfigs.get(arch, smoke=True), **kw),
            _fp32(configs.get(arch, smoke=True), **kw))


def _jparams(cfg, seed=0):
    return jax.tree.map(np.asarray, jmodels.init(jax.random.PRNGKey(seed),
                                                 cfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ----------------------------------------------------------------------
# configs and init
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.all_arch_ids())
def test_configs_equal_the_reference(arch):
    assert configs.all_arch_ids() == jconfigs.all_arch_ids()
    for smoke in (False, True):
        mine, ref = configs.get(arch, smoke), jconfigs.get(arch, smoke)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        for prop in ("n_groups", "d_inner", "is_enc_dec", "has_cross",
                     "cross_len", "attn_free", "padded_vocab",
                     "sub_quadratic"):
            assert getattr(mine, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("arch", PORTED)
def test_param_counts_equal_the_reference(arch):
    """From the port's init on the meta device, at full and SMOKE size."""
    for smoke in (False, True):
        mine, ref = configs.get(arch, smoke), jconfigs.get(arch, smoke)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", PORTED)
def test_init_builds_the_reference_pytree(arch):
    """Same nesting, shapes and dtypes as the reference's SMOKE params
    (bf16 weights, fp32 SSM leaves)."""
    cfg, jcfg = configs.get(arch, smoke=True), jconfigs.get(arch, smoke=True)
    mine = tree_to_numpy(models.init(torch.Generator().manual_seed(0), cfg,
                                     "cpu"))
    ref = _jparams(jcfg)
    flat_m, tree_m = jax.tree.flatten(mine)
    flat_r, tree_r = jax.tree.flatten(ref)
    assert tree_m == tree_r
    for a, b in zip(flat_m, flat_r):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert all(np.isfinite(np.asarray(a, np.float32)).all() for a in flat_m)


def test_init_draws_match_the_reference_statistics():
    """dense_init draws N(0, 1/fan_in); A_log and dt_bias as the
    reference builds them."""
    cfg = _fp32(configs.get("falcon-mamba-7b", smoke=True))
    p = models.init(torch.Generator().manual_seed(1), cfg, "cpu")
    w = p["groups"][0]["mamba"]["in_proj"]
    assert abs(w.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.02
    m = p["groups"][0]["mamba"]
    np.testing.assert_allclose(
        m["A_log"][0, 0].numpy(), np.log(np.arange(1, cfg.ssm_state + 1)),
        rtol=1e-6)
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert bool(((dt > 9e-4) & (dt < 0.11)).all())
    # every group gets its own draw
    assert not torch.equal(w[0], w[1])


def test_tree_round_trip_keeps_dtypes():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": (rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
                  {"c": np.arange(6, dtype=np.int32).reshape(2, 3)}),
            "d": [rng.normal(size=(2,)).astype(np.float32)]}
    t = tree_from_jax(tree, "cpu")
    assert t["b"][0].dtype == torch.bfloat16
    assert t["b"][1]["c"].dtype == torch.int32
    assert isinstance(t["b"], tuple) and isinstance(t["d"], list)
    back = tree_to_numpy(t)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.astype(np.float32),
                                      y.astype(np.float32))
    # the reference's own bf16 params cross exactly
    ref = _jparams(jconfigs.get("h2o-danube-1.8b", smoke=True))
    for x, y in zip(jax.tree.leaves(tree_to_numpy(tree_from_jax(ref, "cpu"))),
                    jax.tree.leaves(ref)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.view(np.uint16) if x.dtype.itemsize
                                      == 2 else x,
                                      y.view(np.uint16) if y.dtype.itemsize
                                      == 2 else y)


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------

def test_norms_and_activations_match_the_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    s = rng.normal(size=(64,)).astype(np.float32) * 0.1
    b = rng.normal(size=(64,)).astype(np.float32) * 0.1
    _close(layers.rms_norm(_t(x), _t(s)), jlayers.rms_norm(x, s))
    _close(layers.layer_norm(_t(x), _t(s), _t(b)),
           jlayers.layer_norm(x, s, b))
    for kind in ("swiglu", "geglu", "gelu", "relu"):
        _close(layers.activation(_t(x), kind), jlayers.activation(x, kind))
    # bf16 in, bf16 out, computed in fp32
    xb = _t(x).to(torch.bfloat16)
    got = layers.rms_norm(xb, _t(s))
    assert got.dtype == torch.bfloat16
    want = jlayers.rms_norm(jnp.asarray(xb.float().numpy(), jnp.bfloat16), s)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu"])
def test_mlp_matches_the_reference(activation):
    jcfg, cfg = _pair("minitron-8b", activation=activation)
    ref = _jparams(jcfg)
    jp = jax.tree.map(lambda a: a[0], ref["groups"][0]["mlp"])
    x = np.random.default_rng(3).normal(size=(2, 7, cfg.d_model)).astype(
        np.float32)
    _close(layers.apply_mlp(_t(x), tree_from_jax(jp, "cpu"), cfg),
           jlayers.apply_mlp(jnp.asarray(x), jp, jcfg), 1e-4)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------

def _qkv_bshd(B, S, H, K, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, dh)).astype(np.float32),
            rng.normal(size=(B, S, K, dh)).astype(np.float32),
            rng.normal(size=(B, S, K, dh)).astype(np.float32))


def test_rope_matches_the_reference():
    x = np.random.default_rng(4).normal(size=(2, 9, 3, 32)).astype(
        np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    _close(attention.rope(_t(x), _t(pos), 10_000.0),
           jattn.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), 2e-5)


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None),
                                            (None, 20.0)])
def test_sdpa_and_blockwise_match_the_reference(window, softcap):
    B, S, H, K, dh = 2, 37, 4, 2, 16
    q, k, v = _qkv_bshd(B, S, H, K, dh, 5)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    mask = jattn._causal_mask(jnp.asarray(pos), jnp.asarray(pos), window)
    tmask = attention._causal_mask(_t(pos), _t(pos), window)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    _close(attention._sdpa(_t(q), _t(k), _t(v), tmask, softcap),
           jattn._sdpa(q, k, v, mask, softcap))
    for chunk in (8, 16):       # chunk + window < S: the sliced path
        _close(attention._blockwise(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                    window, chunk, softcap),
               jattn._blockwise(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos),
                                jnp.asarray(pos), window, chunk, softcap))


@pytest.mark.parametrize("direct_max,use_kernels", [(64, False), (16, False),
                                                     (16, True)])
def test_self_attention_forward_matches_the_reference(direct_max,
                                                      use_kernels):
    """Direct, blockwise and kernel routes of the forward (S = 40)."""
    jcfg, cfg = _pair("h2o-danube-1.8b", attn_direct_max=direct_max,
                      attn_chunk=16, use_kernels=use_kernels)
    jp = jax.tree.map(lambda a: a[0], _jparams(jcfg)["groups"][0]["attn"])
    x = np.random.default_rng(6).normal(size=(2, 40, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    want, wc = jattn.self_attention(jnp.asarray(x), jp, jcfg,
                                    jnp.asarray(pos), cfg.window)
    got, gc = attention.self_attention(_t(x), tree_from_jax(jp, "cpu"), cfg,
                                       _t(pos).long(), cfg.window)
    _close(got, want, 1e-4)
    _close(gc["k"], wc["k"], 1e-5)
    _close(gc["v"], wc["v"], 1e-5)


def test_self_attention_decode_ring_matches_the_reference():
    """24 decode steps through SMOKE's window of 16: the ring buffer
    wraps; every step's output and the cache equal the reference's."""
    jcfg, cfg = _pair("h2o-danube-1.8b")
    jp = jax.tree.map(lambda a: a[0], _jparams(jcfg)["groups"][0]["attn"])
    tp = tree_from_jax(jp, "cpu")
    T, B = 24, 2
    C = min(cfg.window, T)
    xs = np.random.default_rng(7).normal(size=(B, T, cfg.d_model)).astype(
        np.float32)
    shape = (B, C, cfg.n_kv_heads, cfg.head_dim)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for t in range(T):
        pos = np.full((B, 1), t, np.int32)
        want, jc = jattn.self_attention(jnp.asarray(xs[:, t:t + 1]), jp,
                                        jcfg, jnp.asarray(pos), cfg.window,
                                        cache=jc, cache_index=jnp.int32(t))
        got, tc = attention.self_attention(_t(xs[:, t:t + 1]), tp, cfg,
                                           _t(pos).long(), cfg.window,
                                           cache=tc, cache_index=t)
        _close(got, want, 1e-4)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


# ----------------------------------------------------------------------
# mamba
# ----------------------------------------------------------------------

def test_causal_conv_and_coeffs_match_the_reference():
    jcfg, cfg = _pair("falcon-mamba-7b")
    jp = jax.tree.map(lambda a: a[0], _jparams(jcfg)["groups"][0]["mamba"])
    tp = tree_from_jax(jp, "cpu")
    x = np.random.default_rng(8).normal(size=(2, 11, cfg.d_inner)).astype(
        np.float32)
    _close(mamba._causal_conv(_t(x), tp["conv_w"], tp["conv_b"]),
           jmamba._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"]))
    for got, want in zip(mamba._ssm_coeffs(_t(x), tp, cfg),
                         jmamba._ssm_coeffs(jnp.asarray(x), jp, jcfg)):
        _close(got, want)


def test_chunk_scan_matches_the_reference():
    rng = np.random.default_rng(9)
    dA = np.exp(-np.abs(rng.normal(size=(2, 13, 6, 4)))).astype(np.float32)
    dBx = rng.normal(size=(2, 13, 6, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 6, 4)).astype(np.float32)
    got = mamba._chunk_scan(_t(dA), _t(dBx), _t(h0))
    want = jmamba._chunk_scan(jnp.asarray(dA), jnp.asarray(dBx),
                              jnp.asarray(h0))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("S", [9, 300])      # one chunk; two, the last ragged
def test_mamba_forward_plain_matches_the_reference(S):
    jcfg, cfg = _pair("falcon-mamba-7b")
    jp = jax.tree.map(lambda a: a[0], _jparams(jcfg)["groups"][0]["mamba"])
    x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(
        np.float32)
    want, wc = jmamba.mamba_mixer(jnp.asarray(x), jp, jcfg)
    got, gc = mamba.mamba_mixer(_t(x), tree_from_jax(jp, "cpu"), cfg)
    _close(got, want, 1e-4)
    _close(gc["conv"], wc["conv"])
    _close(gc["ssm"], wc["ssm"], 1e-4)


def test_mamba_forward_kernel_route_matches_the_reference(pallas_store):
    """The kernel route against the reference's (interpret mode): the same
    output and conv state; its SSM state is the reference's plain-path
    state, where the reference's kernel path hands decode zeros."""
    jcfg, cfg = _pair("falcon-mamba-7b", use_kernels=True)
    jp = jax.tree.map(lambda a: a[0], _jparams(jcfg)["groups"][0]["mamba"])
    x = np.random.default_rng(10).normal(size=(2, 20, cfg.d_model)).astype(
        np.float32)
    want, wc = jmamba.mamba_mixer(jnp.asarray(x), jp, jcfg)
    _, wplain = jmamba.mamba_mixer(jnp.asarray(x), jp,
                                   dataclasses.replace(jcfg,
                                                       use_kernels=False))
    got, gc = mamba.mamba_mixer(_t(x), tree_from_jax(jp, "cpu"), cfg)
    _close(got, want, 1e-4)
    _close(gc["conv"], wc["conv"])
    assert not np.asarray(wc["ssm"]).any()
    _close(gc["ssm"], wplain["ssm"], 1e-4)


def test_mamba_decode_matches_the_reference():
    jcfg, cfg = _pair("falcon-mamba-7b")
    jp = jax.tree.map(lambda a: a[0], _jparams(jcfg)["groups"][0]["mamba"])
    tp = tree_from_jax(jp, "cpu")
    xs = np.random.default_rng(12).normal(size=(2, 6, cfg.d_model)).astype(
        np.float32)
    jc = jmamba.init_mamba_cache(jcfg, 2)
    tc = mamba.init_mamba_cache(cfg, 2, "cpu")
    for t in range(6):
        want, jc = jmamba.mamba_mixer(jnp.asarray(xs[:, t:t + 1]), jp, jcfg,
                                      cache=jc, cache_index=jnp.int32(t))
        got, tc = mamba.mamba_mixer(_t(xs[:, t:t + 1]), tp, cfg, cache=tc,
                                    cache_index=t)
        _close(got, want, 1e-4)
    _close(tc["conv"], jc["conv"])
    _close(tc["ssm"], jc["ssm"])
