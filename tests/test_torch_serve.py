"""The zoo's serving path in the port against the JAX reference, on the
CPU: the SMOKE configs of h2o-danube-1.8b, falcon-mamba-7b and the five
that bring MoE, cross attention and the encoder (deepseek-moe-16b,
kimi-k2-1t-a32b, jamba-v0.1-52b, whisper-medium, llama-3.2-vision-90b) in
fp32.  whisper takes frame embeddings through its encoder, llama-vision
patch embeddings, both from the seed's numpy draw; every cross layer's
``xgate`` is 0.5 in both packages' params (at init tanh(0) = 0 would hide
the cross path), and greedy serving starts from a cache whose cross K/V
each package computed from those embeddings.

* ``make_prefill``: last-position logits and the cache against the
  reference's ``launch.serve.make_prefill(cfg, None)``, kernels off and on
  (on: attn_direct_max 16 < S, so attention takes the flash route; the
  reference runs its Pallas kernels in interpret mode).
* Greedy serving as ``examples/serve_decode.py`` does it (teacher-force
  the prompt through the serve step, then argmax), token for token
  against the reference's ``make_serve_step``.
* ``make_forward``'s loss against the reference's.
* Decode against the forward, in the port: the decode-equivalence cases
  of ``tests/test_decode_equivalence.py`` without MoE or cross attention
  (those are in ``test_torch_s7b.py``), and two through the kernel route.
* The reference's kernel path hands decode a zero SSM state; the port's
  prefill state is the reference's plain-path state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch import configs, models
from repro_torch.convert import tree_from_jax, tree_to_numpy
from repro_torch.launch.serve import (make_forward, make_prefill,
                                      make_serve_step)
from repro_torch.models import ModelConfig, attention, frontends
from repro_torch.models import model as tmodel

ARCHS = ("h2o-danube-1.8b", "falcon-mamba-7b", "deepseek-moe-16b",
         "kimi-k2-1t-a32b", "jamba-v0.1-52b", "whisper-medium",
         "llama-3.2-vision-90b")
XGATE = 0.5


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


def _pair(arch, **kw):
    kw = dict(dtype="float32", param_dtype="float32", **kw)
    return (dataclasses.replace(jconfigs.get(arch, smoke=True), **kw),
            dataclasses.replace(configs.get(arch, smoke=True), **kw))


def _setup(arch, seed=0, B=2, S=40, **kw):
    """-> (jcfg, cfg, reference params, port params, tokens, embeddings):
    the embeddings are {} or {"enc_emb" | "cross_emb": (B, L, D) numpy}."""
    jcfg, cfg = _pair(arch, **kw)
    jp = jax.tree.map(np.asarray, jmodels.init(jax.random.PRNGKey(seed),
                                               jcfg))
    jp["groups"] = tuple({k: (np.full_like(v, XGATE) if k == "xgate" else v)
                          for k, v in g.items()} for g in jp["groups"])
    tp = tree_from_jax(jp, "cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    emb = {}
    if cfg.is_enc_dec or cfg.has_cross:
        emb["enc_emb" if cfg.is_enc_dec else "cross_emb"] = rng.normal(
            size=(B, cfg.cross_len, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, tp, toks, emb


def _temb(emb):
    return {k: torch.from_numpy(v) for k, v in emb.items()}


def _cross_layers(cfg):
    return [li for li, (m, _) in enumerate(cfg.layout)
            if m in ("xattn", "attn_x")]


def _ref_cache(jcfg, jp, B, C, emb):
    """The reference's init_cache with each cross layer's K/V computed
    from the embeddings (the encoder's output for enc-dec), as a prefill
    leaves them."""
    cache = jmodels.init_cache(jcfg, B, C)
    if not emb:
        return cache
    src = (jmodel._encode(jp, jcfg, jnp.asarray(emb["enc_emb"]))
           if jcfg.is_enc_dec else jnp.asarray(emb["cross_emb"]))
    groups = list(cache["groups"])
    for li in _cross_layers(jcfg):
        kv = jax.vmap(lambda w: jattn.make_cross_kv(src, w, jcfg))(
            jp["groups"][li]["xattn"])
        groups[li] = dict(groups[li], cross=kv)
    cache["groups"] = tuple(groups)
    return cache


def _port_cache(cfg, tp, B, C, emb):
    """The port's counterpart of _ref_cache, from its own encoder and
    make_cross_kv."""
    cache = models.init_cache(cfg, B, C, "cpu")
    if not emb:
        return cache
    temb = _temb(emb)
    src = (tmodel._encode(tp, cfg, temb["enc_emb"]) if cfg.is_enc_dec
           else temb["cross_emb"])
    for li in _cross_layers(cfg):
        xp = tp["groups"][li]["xattn"]
        for g in range(cfg.n_groups):
            kv = attention.make_cross_kv(src, {k: v[g] for k, v in
                                               xp.items()}, cfg)
            for key in ("k", "v"):
                cache["groups"][li]["cross"][key][g].copy_(kv[key])
    return cache


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _close_tree(got, want, tol):
    g, w = jax.tree.leaves(tree_to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == np.asarray(b).shape
        _close(a, b, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_the_reference(arch):
    """Kernels off: the blockwise attention (S = 40 > attn_direct_max 16,
    chunks of 16, the window slice) and the chunked scan."""
    jcfg, cfg, jp, tp, toks, emb = _setup(arch, attn_direct_max=16,
                                          attn_chunk=16)
    want_lg, want_cache = jserve.make_prefill(jcfg, None)(jp, toks, **emb)
    lg, cache = make_prefill(cfg)(tp, torch.from_numpy(toks).long(),
                                  **_temb(emb))
    assert tuple(lg.shape) == (2, 1, cfg.padded_vocab)
    _close(lg, want_lg, 1e-4)
    _close_tree(cache, want_cache, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_kernel_route_matches_the_reference(arch, pallas_store):
    """Kernels on: the port's plain kernel versions against the
    reference's interpret-mode Pallas kernels.  The caches agree; a Mamba
    layer's conv state is held to 1e-5 against the reference's kernel
    path, then the whole cache to 1e-4 against its plain path, since its
    kernel path zeroes the SSM state (see test_kernel_path_ssm_state) and
    no other leaf depends on the route."""
    jcfg, cfg, jp, tp, toks, emb = _setup(arch, attn_direct_max=16,
                                          use_kernels=True)
    want_lg, want_cache = jserve.make_prefill(jcfg, None)(jp, toks, **emb)
    lg, cache = make_prefill(cfg)(tp, torch.from_numpy(toks).long(),
                                  **_temb(emb))
    _close(lg, want_lg, 1e-4)
    mamba = [li for li, (m, _) in enumerate(cfg.layout) if m == "mamba"]
    for li in mamba:
        _close(cache["groups"][li]["conv"], want_cache["groups"][li]["conv"],
               1e-5)
    if mamba:
        _, want_cache = jserve.make_prefill(
            dataclasses.replace(jcfg, use_kernels=False), None)(jp, toks,
                                                                **emb)
    _close_tree(cache, want_cache, 1e-4)


def test_kernel_path_ssm_state(pallas_store):
    """The reference's kernel-path prefill hands decode a zero SSM state
    (repro/models/mamba.py:120-121); its plain path exports the scan's
    final state.  The port's kernel route exports that final state."""
    jcfg, cfg, jp, tp, toks, _ = _setup("falcon-mamba-7b",
                                        use_kernels=True)
    _, ref_kernel = jserve.make_prefill(jcfg, None)(jp, toks)
    _, ref_plain = jserve.make_prefill(
        dataclasses.replace(jcfg, use_kernels=False), None)(jp, toks)
    _, mine = make_prefill(cfg)(tp, torch.from_numpy(toks).long())
    assert not np.asarray(ref_kernel["groups"][0]["ssm"]).any()
    assert np.abs(np.asarray(ref_plain["groups"][0]["ssm"])).max() > 0.1
    _close(mine["groups"][0]["ssm"], ref_plain["groups"][0]["ssm"], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_matches_the_reference(arch):
    """4 requests, an 8-token prompt teacher-forced, 12 tokens generated:
    the port's serve step against the reference's, token for token (each
    package's cross K/V computed from the same embeddings)."""
    jcfg, cfg, jp, tp, toks, emb = _setup(arch, seed=3, B=4, S=8)
    P, G = 8, 12
    jstep = jserve.make_serve_step(jcfg, None, donate_cache=False)
    step = make_serve_step(cfg)
    jcache = _ref_cache(jcfg, jp, 4, P + G, emb)
    cache = _port_cache(cfg, tp, 4, P + G, emb)
    _close_tree(cache, jcache, 1e-4)
    jtok = jnp.asarray(toks[:, :1])
    tok = torch.from_numpy(toks[:, :1]).long()
    out_j, out_t = [], []
    for t in range(P + G - 1):
        jnext, jcache = jstep(jp, jtok, jcache, jnp.int32(t))
        nxt, cache = step(tp, tok, cache, t)
        if t + 1 < P:
            jtok = jnp.asarray(toks[:, t + 1:t + 2])
            tok = torch.from_numpy(toks[:, t + 1:t + 2]).long()
        else:
            jtok, tok = jnext, nxt
        out_j.append(np.asarray(jtok))
        out_t.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(out_t, 1),
                                  np.concatenate(out_j, 1))
    _close_tree(cache, jcache, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_matches_the_reference(arch):
    """The mean next-token loss plus the MoE layers' aux losses."""
    jcfg, cfg, jp, tp, toks, emb = _setup(arch, loss_chunk=24)
    want = jserve.make_forward(jcfg, None)(jp, toks, **emb)
    got = make_forward(cfg)(tp, torch.from_numpy(toks).long(), **_temb(emb))
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want, 1e-5)


DECODE_CASES = {
    "dense_gqa": dict(name="d", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab_size=97,
                      attn_direct_max=64),
    "mqa_geglu": dict(name="m", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=1, d_ff=128, vocab_size=97,
                      activation="geglu", attn_direct_max=64),
    "swa_ring": dict(name="s", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab_size=97,
                     layout=(("swa", "mlp"),), window=8,
                     attn_direct_max=64),
    "mamba": dict(name="ssm", n_layers=3, d_model=48, n_heads=0,
                  n_kv_heads=0, d_ff=0, vocab_size=97,
                  layout=(("mamba", "none"),), ssm_state=8),
    "swa_kernel": dict(name="sk", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=128, vocab_size=97,
                       layout=(("swa", "mlp"),), window=8,
                       attn_direct_max=8, use_kernels=True),
    "mamba_kernel": dict(name="sskern", n_layers=3, d_model=48, n_heads=0,
                         n_kv_heads=0, d_ff=0, vocab_size=97,
                         layout=(("mamba", "none"),), ssm_state=8,
                         use_kernels=True),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_forward(case):
    """Token by token through decode_step with the KV/SSM cache equals the
    full-sequence forward (2e-3, as tests/test_decode_equivalence.py);
    the prefill's cache equals the decode's at the end for Mamba."""
    cfg = ModelConfig(**DECODE_CASES[case], dtype="float32",
                      param_dtype="float32")
    T = 20
    params = models.init(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, T)))
    with torch.inference_mode():
        out = models.apply(params, cfg, toks, want_cache=True)
        full = models.logits(params, cfg, out["hidden"])
        cache = models.init_cache(cfg, 2, T, "cpu")
        dec = []
        for t in range(T):
            lg, cache = models.decode_step(params, cfg, toks[:, t:t + 1],
                                           cache, t)
            dec.append(lg[:, 0])
    _close(torch.stack(dec, dim=1), full, 2e-3)
    if cfg.attn_free:
        for key in ("conv", "ssm"):
            _close(cache["groups"][0][key], out["cache"]["groups"][0][key],
                   2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_configs_serve_in_bf16(arch):
    """The SMOKE configs as published (bf16): prefill through the kernel
    route (whisper's frames and llama-vision's patches from the frontend
    stubs) and greedy serving give finite logits and in-vocab tokens, and
    the serve step writes the cache in place."""
    cfg = dataclasses.replace(configs.get(arch, smoke=True),
                              use_kernels=True, attn_direct_max=16)
    params = models.init(torch.Generator().manual_seed(0), cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    emb = {}
    if cfg.is_enc_dec:
        emb["enc_emb"] = frontends.audio_frames(gen, 2, cfg, "cpu")
    elif cfg.has_cross:
        emb["cross_emb"] = frontends.vision_patches(gen, 2, cfg, "cpu")
    lg, cache = make_prefill(cfg)(params, toks, **emb)
    assert bool(torch.isfinite(lg[..., :cfg.vocab_size]).all())
    assert bool((lg[..., cfg.vocab_size:] == -1e30).all())
    step = make_serve_step(cfg)
    cache = models.init_cache(cfg, 2, 8, "cpu")
    leaves = jax.tree.leaves(cache)
    tok = toks[:, :1]
    for t in range(8):
        tok, new = step(params, tok, cache, t)
        assert all(a is b for a, b in zip(jax.tree.leaves(new), leaves))
        assert bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
