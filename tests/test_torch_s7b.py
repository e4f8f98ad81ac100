"""The zoo's last models in the port against the JAX reference, on the CPU,
in fp32: the MoE FFN, cross attention, the encoder and the frontend stubs.

* ``moe._capacity`` over the reference's parameter grid; ``apply_moe``'s
  output, aux loss and expert ids (the reference's ``jax.lax.top_k``) on
  the reference's params, with a tied router (ties go to the lower id),
  the reference's uniform-router config and its overflow drop
  (``tests/test_model_units.py:48-95``).
* ``make_cross_kv`` and ``cross_attention``, ``model._encode``.
* ``sinusoidal``, and ``audio_frames``/``vision_patches`` on the
  reference's own normal draw injected through ``noise``.
* Decode against the forward (2e-3, as ``tests/test_decode_equivalence.py``)
  for the reference's ``moe`` case, its VLM cross-cache case and an
  encoder-decoder case; one decode step on a zero cache against the
  reference's (``tests/test_arch_smoke.py:56``).

Every check of an ``xattn`` layer sets its ``xgate`` to 0.5 in both
packages' params: at init tanh(0) = 0 would multiply the cross path away.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import attention as jattn
from repro.models import frontends as jfront
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs, models
from repro_torch.convert import tree_from_jax
from repro_torch.models import ModelConfig, attention, frontends, moe
from repro_torch.models import model as tmodel

XGATE = 0.5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                               **kw)


def _pair(arch, **kw):
    return (_fp32(jconfigs.get(arch, smoke=True), **kw),
            _fp32(configs.get(arch, smoke=True), **kw))


def _jparams(cfg, seed=0):
    """The reference's params as numpy, every xgate set to XGATE."""
    p = jax.tree.map(np.asarray, jmodels.init(jax.random.PRNGKey(seed), cfg))
    p["groups"] = tuple({k: (np.full_like(v, XGATE) if k == "xgate" else v)
                         for k, v in g.items()} for g in p["groups"])
    return p


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------

@pytest.mark.parametrize("factor", [0.25, 1.25, 8.0, 16.0])
def test_capacity_matches_the_reference(factor):
    """The reference's grid (t in 8..200, e in 2..8, k in 1..4) at four
    capacity factors; a multiple of 8, at least 8, and at factor >= 1
    enough for perfect balance."""
    for t in (8, 9, 31, 64, 100, 137, 200):
        for e in range(2, 9):
            for k in range(1, 5):
                kw = dict(name="m", n_layers=1, d_model=32, n_heads=2,
                          n_kv_heads=2, d_ff=64, vocab_size=64,
                          layout=(("attn", "moe"),), n_experts=e,
                          top_k=min(k, e), d_expert=16,
                          capacity_factor=factor)
                c = moe._capacity(t, ModelConfig(**kw))
                assert c == jmoe._capacity(t, jmodels.ModelConfig(**kw))
                assert c % 8 == 0 and c >= 8
                if factor >= 1:
                    assert c * e >= t * min(k, e)


_UNIT = dict(name="m", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
             d_ff=32, vocab_size=64, layout=(("attn", "moe"),),
             dtype="float32", param_dtype="float32")
MOE_CASES = {
    # the SMOKE configs' MoE layers (shared experts; jamba's has none)
    "deepseek": ("deepseek-moe-16b", None, (2, 12), 1.0),
    "jamba": ("jamba-v0.1-52b", None, (2, 12), 1.0),
    # an ungated activation through the routed experts
    "gelu": ("kimi-k2-1t-a32b", dict(activation="gelu"), (2, 12), 1.0),
    # tests/test_model_units.py:58 and :80
    "uniform": (None, dict(n_experts=4, top_k=2, d_expert=8,
                           capacity_factor=16.0), (2, 6), 0.3),
    "overflow": (None, dict(n_experts=4, top_k=1, d_expert=8,
                            capacity_factor=0.25), (1, 64), 1.0),
    # a zero router: every token's probabilities tie
    "tied": (None, dict(n_experts=4, top_k=2, d_expert=8,
                        capacity_factor=2.0), (2, 10), 1.0),
}


def _moe_case(case):
    arch, kw, (B, S), scale = MOE_CASES[case]
    if arch is None:
        jcfg, cfg = jmodels.ModelConfig(**_UNIT, **kw), ModelConfig(**_UNIT,
                                                                     **kw)
    else:
        jcfg, cfg = _pair(arch, **(kw or {}))
    jp = jax.tree.map(np.asarray, jmoe.make_moe_params(
        jax.random.PRNGKey(0), jcfg))
    x = _normal((B, S, cfg.d_model), 1, scale)
    if case == "overflow":
        jp["router"] = np.zeros_like(jp["router"])
        jp["router"][:, 0] = 10.0
        x = np.abs(x)
    elif case == "tied":
        jp["router"] = np.zeros_like(jp["router"])
    return jcfg, cfg, jp, x


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_the_reference(case):
    """Output and aux within 1e-5 on the reference's params; the expert
    ids are the reference's top k, ties to the lower id."""
    jcfg, cfg, jp, x = _moe_case(case)
    want, want_aux = jmoe.apply_moe(jnp.asarray(x), jp, jcfg)
    got, aux = moe.apply_moe(_t(x), tree_from_jax(jp, "cpu"), cfg)
    assert got.shape == x.shape and aux.dtype == torch.float32
    _close(got, want, 1e-5)
    _close(aux, want_aux, 1e-5)
    xf = x.reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], axis=-1)
    want_gates, want_idx = jax.lax.top_k(probs, cfg.top_k)
    _, gates, idx = moe._route(_t(xf), _t(jp["router"]), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    want_gates = want_gates / jnp.maximum(want_gates.sum(-1, keepdims=True),
                                          1e-9)
    _close(gates, want_gates, 1e-6)
    if case == "tied":
        assert (idx.numpy() == np.arange(cfg.top_k)).all()
    if case == "overflow":
        # only C tokens are served, the rest dropped
        served = int((got[0].abs().sum(-1) > 1e-9).sum())
        assert 0 < served <= moe._capacity(64, cfg)


def test_apply_moe_is_deterministic_and_permutation_equivariant():
    """tests/test_model_units.py:58's properties: two calls equal bitwise,
    and permuting the tokens permutes the output when nothing drops."""
    jcfg, cfg, jp, x = _moe_case("uniform")
    p = tree_from_jax(jp, "cpu")
    out1, aux1 = moe.apply_moe(_t(x), p, cfg)
    out2, aux2 = moe.apply_moe(_t(x), p, cfg)
    assert torch.equal(out1, out2) and torch.equal(aux1, aux2)
    perm = [3, 1, 0, 5, 4, 2]
    out_p, _ = moe.apply_moe(_t(x[:, perm]), p, cfg)
    _close(out_p, out1[:, perm], 2e-5)


def test_moe_combine_adds_in_slot_order_bitwise():
    """In bf16 the combine rounds after every add, so with three experts a
    token its order shows: the port's equals the reference's scatter-add
    done one slot at a time in slot order (XLA:CPU's sequential scatter),
    bitwise, with drops."""
    cfg = dataclasses.replace(configs.get("deepseek-moe-16b", smoke=True),
                              top_k=3, capacity_factor=0.5)
    p = moe.make_moe_params(torch.Generator().manual_seed(0), cfg, "cpu")
    del p["shared"]
    x = torch.randn((2, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    got, _ = moe.apply_moe(x, p, cfg)
    # the reference's dispatch, step for step, then its scatter-add
    E, K, D, t = cfg.n_experts, cfg.top_k, cfg.d_model, 48
    xf = x.reshape(t, D)
    _, gates, idx = moe._route(xf, p["router"], K)
    C = moe._capacity(t, cfg)
    eids = idx.reshape(-1)
    order = torch.argsort(eids, stable=True)
    counts = torch.bincount(eids, minlength=E)
    pos = torch.arange(t * K) - (torch.cumsum(counts, 0) - counts)[
        eids[order]]
    keep = pos < C
    assert not keep.all()                       # some assignments drop
    dest = torch.where(keep, eids[order] * C + pos.clamp(0, C - 1), E * C)
    slot_tok = torch.full((E * C + 1,), t)
    slot_tok[dest] = order // K
    slot_gate = torch.zeros(E * C + 1)
    slot_gate[dest] = keep * gates.reshape(-1)[order]
    h = torch.cat([xf, xf.new_zeros((1, D))])[slot_tok[:E * C]].reshape(
        E, C, D)
    hidden = torch.nn.functional.silu(torch.bmm(h, p["routed_gate"])) * \
        torch.bmm(h, p["routed_up"])
    y = torch.bmm(hidden, p["routed_down"]).reshape(E * C, D)
    contrib = y * slot_gate[:E * C, None].bfloat16()
    want = torch.zeros((t + 1, D), dtype=torch.bfloat16)
    for slot in range(E * C):
        want[slot_tok[slot]] += contrib[slot]
    assert torch.equal(got.reshape(t, D), want[:t])


# ----------------------------------------------------------------------
# cross attention, the encoder
# ----------------------------------------------------------------------

@pytest.mark.parametrize("softcap", [None, 30.0])
def test_cross_attention_matches_the_reference(softcap):
    jcfg, cfg = _pair("llama-3.2-vision-90b", logit_softcap=softcap)
    jp = jax.tree.map(lambda a: a[0], _jparams(jcfg)["groups"][4]["xattn"])
    tp = tree_from_jax(jp, "cpu")
    emb = _normal((2, cfg.n_patches, cfg.d_model), 2)
    x = _normal((2, 9, cfg.d_model), 3)
    want_kv = jattn.make_cross_kv(jnp.asarray(emb), jp, jcfg)
    kv = attention.make_cross_kv(_t(emb), tp, cfg)
    for key in ("k", "v"):
        assert kv[key].shape == (2, cfg.n_patches, cfg.n_kv_heads,
                                 cfg.head_dim)
        _close(kv[key], want_kv[key], 1e-5)
    _close(attention.cross_attention(_t(x), tp, cfg, kv),
           jattn.cross_attention(jnp.asarray(x), jp, jcfg, want_kv), 1e-5)


def test_encode_matches_the_reference():
    jcfg, cfg = _pair("whisper-medium")
    jp = _jparams(jcfg)
    emb = _normal((2, cfg.enc_seq, cfg.d_model), 4)
    want = jmodel._encode(jp, jcfg, jnp.asarray(emb))
    got = tmodel._encode(tree_from_jax(jp, "cpu"), cfg, _t(emb))
    assert got.shape == emb.shape
    _close(got, want, 1e-4)


# ----------------------------------------------------------------------
# frontends
# ----------------------------------------------------------------------

def _sin_bar(length, dim):
    """1e-6, plus what one fp32 ulp of a frequency moves the angle: XLA's
    fp32 exp is not correctly rounded (torch's is, but for a few in 100),
    and a frequency one ulp apart turns position p's fp32 angle by up to
    p·ulp(freq) + ulp(angle) <= 2^-22 · angle."""
    half = dim // 2
    freq = np.exp(-np.log(1e4) * np.arange(half) / half)
    ang = np.arange(length)[:, None] * freq
    return 1e-6 + np.concatenate([ang, ang], -1) * 2.0 ** -22


@pytest.mark.parametrize("length,dim", [(7, 10), (64, 128), (1500, 1024),
                                        (1600, 8192)])
def test_sinusoidal_matches_the_reference(length, dim):
    got = frontends.sinusoidal(length, dim, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (length, dim)
    want = np.asarray(jfront.sinusoidal(length, dim))
    assert (np.abs(got.numpy() - want) <= _sin_bar(length, dim)).all()


@pytest.mark.parametrize("kind", ["audio", "vision"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontends_on_injected_noise_match_the_reference(kind, dtype):
    """The reference's own normal draw, injected through ``noise``: the
    same embeddings (in fp32 within the bar of
    test_sinusoidal_matches_the_reference; in bf16 within one step, equal
    but where the fp32 sums round across a bf16 boundary)."""
    arch = "whisper-medium" if kind == "audio" else "llama-3.2-vision-90b"
    kw = dict(dtype=dtype, param_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), **kw)
    cfg = dataclasses.replace(configs.get(arch, smoke=True), **kw)
    jfn, fn = ((jfront.audio_frames, frontends.audio_frames)
               if kind == "audio" else
               (jfront.vision_patches, frontends.vision_patches))
    L = cfg.enc_seq if kind == "audio" else cfg.n_patches
    key = jax.random.PRNGKey(7)
    want = np.asarray(jfn(key, 2, jcfg), np.float32)
    noise = _t(jax.random.normal(key, (2, L, cfg.d_model), jnp.float32))
    got = fn(None, 2, cfg, noise=noise)
    assert got.shape == (2, L, cfg.d_model)
    assert str(got.dtype) == f"torch.{dtype}"
    if dtype == "float32":
        assert (np.abs(got.numpy() - want) <= _sin_bar(L, cfg.d_model)).all()
    else:
        step = np.abs(want) * 2.0 ** -7 + 1e-6
        assert (np.abs(got.float().numpy() - want) <= step).all()
        assert (got.float().numpy() == want).mean() > 0.99


def test_frontends_draw_from_the_generator():
    cfg = _fp32(configs.get("whisper-medium", smoke=True))
    a = frontends.audio_frames(torch.Generator().manual_seed(1), 2, cfg,
                               "cpu")
    b = frontends.audio_frames(torch.Generator().manual_seed(1), 2, cfg,
                               "cpu")
    c = frontends.audio_frames(torch.Generator().manual_seed(2), 2, cfg,
                               "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    pos = frontends.sinusoidal(cfg.enc_seq, cfg.d_model, device="cpu")
    assert abs((a - pos).std().item() - 0.02) < 2e-3
    with pytest.raises(ValueError, match="noise has shape"):
        frontends.vision_patches(None, 2, cfg, noise=torch.zeros(2, 3, 4))


# ----------------------------------------------------------------------
# decode against the forward
# ----------------------------------------------------------------------

MOE_DECODE = dict(name="moe", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=97,
                  layout=(("attn", "moe"),), n_experts=4, top_k=2,
                  n_shared_experts=1, d_expert=32, capacity_factor=8.0,
                  dtype="float32", param_dtype="float32")
VLM_DECODE = dict(name="vlm", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=97,
                  layout=(("attn", "mlp"), ("xattn", "mlp")),
                  frontend="vision", n_patches=8, dtype="float32",
                  param_dtype="float32")


def _decode_all(params, cfg, toks, cache):
    dec = []
    with torch.inference_mode():
        for t in range(toks.shape[1]):
            lg, cache = models.decode_step(params, cfg, toks[:, t:t + 1],
                                           cache, t)
            dec.append(lg[:, 0])
    return torch.stack(dec, dim=1)


def test_moe_decode_matches_forward():
    """tests/test_decode_equivalence.py's moe case (capacity_factor 8:
    nothing drops); the forward also equals the reference's on the same
    params, aux included."""
    jcfg = jmodels.ModelConfig(**MOE_DECODE, remat=False)
    cfg = ModelConfig(**MOE_DECODE)
    jp = jax.tree.map(np.asarray, jmodels.init(jax.random.PRNGKey(0), jcfg))
    params = tree_from_jax(jp, "cpu")
    toks = np.random.default_rng(1).integers(0, 97, (2, 20))
    want = jmodels.apply(jp, jcfg, toks)
    with torch.inference_mode():
        out = models.apply(params, cfg, _t(toks))
        full = models.logits(params, cfg, out["hidden"])
    _close(full, jmodels.logits(jp, jcfg, want["hidden"]), 1e-4)
    _close(out["aux"], want["aux"], 1e-5)
    assert out["aux"].item() > 0
    dec = _decode_all(params, cfg, _t(toks), models.init_cache(cfg, 2, 20,
                                                               "cpu"))
    _close(dec, full, 2e-3)


def test_vlm_decode_uses_cross_cache():
    """tests/test_decode_equivalence.py's VLM case with xgate 0.5: the
    cross K/V go into the cache once (as a prefill would put them) and
    decode reads them; the prefill's own cache holds the same K/V."""
    cfg = ModelConfig(**VLM_DECODE)
    params = models.init(torch.Generator().manual_seed(0), cfg, "cpu")
    params["groups"][1]["xgate"].fill_(XGATE)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 97, (1, 8)))
    emb = _t(_normal((1, 8, 64), 2, 0.1))
    with torch.inference_mode():
        out = models.apply(params, cfg, toks, cross_emb=emb, want_cache=True)
        full = models.logits(params, cfg, out["hidden"])
        no_cross = models.logits(params, cfg, models.apply(
            params, cfg, toks, cross_emb=torch.zeros_like(emb))["hidden"])
    assert (full - no_cross).abs().max() > 1e-2     # the cross path counts
    cache = models.init_cache(cfg, 1, 8, "cpu")
    xp = params["groups"][1]["xattn"]
    for g in range(cfg.n_groups):
        kv = attention.make_cross_kv(emb, {k: v[g] for k, v in xp.items()},
                                     cfg)
        for key in ("k", "v"):
            cache["groups"][1]["cross"][key][g].copy_(kv[key])
            _close(out["cache"]["groups"][1]["cross"][key][g], kv[key], 0)
    _close(_decode_all(params, cfg, toks, cache), full, 2e-3)


def test_enc_dec_decode_matches_forward():
    """whisper-medium's SMOKE config: the attn_x layers' self cache fills
    token by token, their cross cache is the prefill's (the encoder's
    output projected once)."""
    cfg = _fp32(configs.get("whisper-medium", smoke=True))
    params = models.init(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    enc = _t(_normal((2, cfg.enc_seq, cfg.d_model), 2))
    with torch.inference_mode():
        out = models.apply(params, cfg, toks, enc_emb=enc, want_cache=True)
        full = models.logits(params, cfg, out["hidden"])
    cache = models.init_cache(cfg, 2, 12, "cpu")
    for key in ("k", "v"):
        cache["groups"][0]["cross"][key].copy_(
            out["cache"]["groups"][0]["cross"][key])
        _close(cache["groups"][0]["self"][key], 0, 0)
    _close(_decode_all(params, cfg, toks, cache), full, 2e-3)


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-90b",
                                  "deepseek-moe-16b", "jamba-v0.1-52b"])
def test_decode_step_on_a_zero_cache_matches_the_reference(arch):
    """tests/test_arch_smoke.py:56 on both packages: two steps from
    init_cache's zeros (the cross K/V too, which decode reads as they
    are), the logits within 1e-4 and the pad columns masked."""
    jcfg, cfg = _pair(arch)
    jp = _jparams(jcfg)
    tp = tree_from_jax(jp, "cpu")
    jc = jmodels.init_cache(jcfg, 2, 16)
    tc = models.init_cache(cfg, 2, 16, "cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jc)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), tc))
    tok = np.ones((2, 1), np.int32)
    for t in range(2):
        want, jc = jmodels.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                       jnp.int32(t))
        with torch.inference_mode():
            got, tc = models.decode_step(tp, cfg, _t(tok).long(), tc, t)
        _close(got, want, 1e-4)
    assert int(got.argmax(-1).max()) < cfg.vocab_size
