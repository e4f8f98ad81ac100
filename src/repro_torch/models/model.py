"""Model assembly of the zoo: embedding, the stacked layout groups, the
loss, prefill and decode.  The counterpart of ``repro/models/model.py``.

Params layout (the reference's pytree, with torch tensors as leaves)::

  {"embed": (V, D),
   "prelude": [first_k_dense blocks, unstacked],
   "groups": tuple(len(layout)) of block dicts, leaves lead with n_groups,
   "final_norm": {...},
   "encoder": {"groups": (block,), leaves lead with n_enc_layers,
               "final_norm": {...}}                 # enc-dec only
  }

The reference scans the groups with ``jax.lax.scan`` (and checkpoints the
body when ``cfg.remat``); the port runs them in a Python loop, indexing
the stacked leaves, and checkpoints each group (each encoder layer) when
``cfg.remat`` and a backward pass will run.  ``apply``'s ``aux`` is the
sum of the MoE layers' load-balance losses, which ``loss_fn`` adds to the
cross entropy.

On a model axis ms > 1 the params are this rank's tiles
(``sharding.place_params``) and every layer runs split over the model
group (``sharding/api.py``).  The embedding and the head are
vocab-parallel where ``ms`` tiles the padded vocab: a rank looks up the
tokens of its vocab range (zeros elsewhere; the ``all_reduce`` adds one
nonzero term a token, so the embedding is bitwise the meshless one), and
the loss combines the ranks' log-sum-exps from one ``all_gather`` and the
target logit from one ``all_reduce``.  ``logits`` gathers the rank's
vocab block.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..sharding.api import (copy_to_model, gather_tile, get_mesh,
                            reduce_from_model, shard, tp_rank_count, use_mesh)
from .attention import (cross_attention, encoder_attention, kv_heads,
                        make_attn_params, make_cross_kv, self_attention)
from .config import ModelConfig, torch_dtype
from .layers import (apply_mlp, apply_norm, dense_init, make_mlp_params,
                     make_norm_params)
from .mamba import init_mamba_cache, make_mamba_params, mamba_mixer
from .moe import apply_moe, make_moe_params


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------

def _make_block_params(gen, cfg: ModelConfig, entry, device, lead=(),
                       force_mlp=False):
    mixer, ffn = entry
    p = {"ln1": make_norm_params(gen, cfg, device, lead=lead)}
    if mixer in ("attn", "swa"):
        p["attn"] = make_attn_params(gen, cfg, device, lead=lead)
    elif mixer == "mamba":
        p["mamba"] = make_mamba_params(gen, cfg, device, lead=lead)
    elif mixer == "xattn":
        p["xattn"] = make_attn_params(gen, cfg, device, lead=lead)
        # tanh(0) = 0: a cross layer starts as the identity
        p["xgate"] = torch.zeros(lead, dtype=torch.float32, device=device)
    elif mixer == "attn_x":
        p["attn"] = make_attn_params(gen, cfg, device, lead=lead)
        p["ln_x"] = make_norm_params(gen, cfg, device, lead=lead)
        p["xattn"] = make_attn_params(gen, cfg, device, lead=lead)
    else:
        raise ValueError(mixer)
    if force_mlp:
        ffn = "mlp"
    if ffn == "mlp":
        p["ln2"] = make_norm_params(gen, cfg, device, lead=lead)
        p["mlp"] = make_mlp_params(gen, cfg, device, lead=lead)
    elif ffn == "moe":
        p["ln2"] = make_norm_params(gen, cfg, device, lead=lead)
        p["moe"] = make_moe_params(gen, cfg, device, lead=lead)
    elif ffn != "none":
        raise ValueError(ffn)
    return p


def init(gen: Optional[torch.Generator], cfg: ModelConfig,
         device: DeviceLike = None):
    """Random parameters from ``gen``, built leaf by leaf in
    ``cfg.param_dtype`` directly on ``device`` (the card unless given; on
    ``"meta"`` nothing is drawn or stored)."""
    dev = resolve_device(device)
    params = {"embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                  cfg.param_dtype, dev, fan_in=cfg.d_model),
              "final_norm": make_norm_params(gen, cfg, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       cfg.param_dtype, dev)
    if cfg.first_k_dense:
        params["prelude"] = [_make_block_params(gen, cfg, ("attn", "mlp"),
                                                dev)
                             for _ in range(cfg.first_k_dense)]
    params["groups"] = tuple(
        _make_block_params(gen, cfg, e, dev, lead=(cfg.n_groups,))
        for e in cfg.layout)
    if cfg.is_enc_dec:
        params["encoder"] = {
            "groups": (_make_block_params(gen, cfg, ("attn", "mlp"), dev,
                                          lead=(cfg.n_enc_layers,)),),
            "final_norm": make_norm_params(gen, cfg, dev)}
    return params


# ----------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------

def _index(tree, g: int):
    """The g-th entry of every stacked leaf (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _write_into(dst, src) -> None:
    """Copy each leaf of ``src`` into the same leaf of ``dst`` unless it
    already is that storage (a KV cache written in place)."""
    if isinstance(dst, dict):
        for k in dst:
            _write_into(dst[k], src[k])
    elif not (src.untyped_storage() is dst.untyped_storage()
              and src.storage_offset() == dst.storage_offset()):
        dst.copy_(src)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _run_block(x, bp, entry, cfg: ModelConfig, positions, cross_emb,
               cache, cache_index):
    """-> (x, new_cache, aux): aux is the MoE FFN's load-balance loss,
    None for a block without one."""
    mixer, _ = entry
    aux = None
    h = apply_norm(x, bp["ln1"], cfg)
    if mixer in ("attn", "swa"):
        window = cfg.window if mixer == "swa" else None
        o, new_cache = self_attention(h, bp["attn"], cfg, positions, window,
                                      cache=cache, cache_index=cache_index)
    elif mixer == "mamba":
        o, new_cache = mamba_mixer(h, bp["mamba"], cfg, cache, cache_index)
    elif mixer == "xattn":
        kv = cache["cross"] if cache is not None else \
            make_cross_kv(cross_emb, bp["xattn"], cfg)
        o = cross_attention(h, bp["xattn"], cfg, kv)
        o = o * torch.tanh(bp["xgate"]).to(o.dtype)
        new_cache = {"cross": kv}
    elif mixer == "attn_x":
        o1, kv_self = self_attention(
            h, bp["attn"], cfg, positions, None,
            cache=None if cache is None else cache["self"],
            cache_index=cache_index)
        x = x + o1
        h2 = apply_norm(x, bp["ln_x"], cfg)
        kv = cache["cross"] if cache is not None else \
            make_cross_kv(cross_emb, bp["xattn"], cfg)
        o = cross_attention(h2, bp["xattn"], cfg, kv)
        new_cache = {"self": kv_self, "cross": kv}
    else:
        raise ValueError(mixer)
    x = x + o
    if "moe" in bp:
        f, aux = apply_moe(apply_norm(x, bp["ln2"], cfg), bp["moe"], cfg)
        x = x + f
    elif "mlp" in bp:
        x = x + apply_mlp(apply_norm(x, bp["ln2"], cfg), bp["mlp"], cfg)
    return x, new_cache, aux


def _run_group(x, aux, gp, cfg: ModelConfig, positions, cross_emb, c_ins,
               cache_index, decode):
    """One layout group: each block in turn.  -> (x, aux, the blocks' new
    caches); aux adds each MoE loss in fp32; decode writes each block's
    cache in place."""
    new_caches = []
    for li, entry in enumerate(cfg.layout):
        x, nc, a = _run_block(x, gp[li], entry, cfg, positions, cross_emb,
                              c_ins[li], cache_index)
        if a is not None:
            aux = aux + a
        if decode:
            _write_into(c_ins[li], nc)
        new_caches.append(nc)
    return x, aux, new_caches


# a forward draws no random numbers, so the recomputation needs no saved
# RNG state (whose save and restore a CUDA graph capture would refuse)
_CKPT = dict(use_reentrant=False, preserve_rng_state=False)


def _under_mesh(fn):
    """``fn`` run under the mesh active now.  A checkpoint region's
    recomputation runs in the backward pass, for CUDA tensors on the
    autograd engine's own thread, where the thread-local active mesh is
    not set, and a split layer would take its tiles for whole leaves."""
    mesh = get_mesh()

    def run(*args):
        with use_mesh(mesh):
            return fn(*args)
    return run


def _remat(cfg: ModelConfig, decode: bool = False) -> bool:
    """Checkpoint each group body (``cfg.remat``) only where a backward
    pass will run: under grad and not decoding, so serving runs exactly
    as without it."""
    return cfg.remat and not decode and torch.is_grad_enabled()


def _scan_groups(x, groups, cfg: ModelConfig, positions, cross_emb,
                 cache, cache_index, decode, collect_cache=False):
    """Run every layout group in order.  -> (x, aux, cache): aux sums the
    MoE losses in fp32; decode: the group caches are updated in place and
    ``cache`` is returned; collect_cache: the forward's caches come back
    stacked like the params; else None.  With :func:`_remat` each group
    is one ``torch.utils.checkpoint`` region: its activations are
    recomputed in the backward pass instead of kept, as the reference's
    ``jax.checkpoint`` of the scanned group body."""
    collected = [[] for _ in cfg.layout]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _remat(cfg, decode)
    for g in range(cfg.n_groups):
        gp = [_index(p, g) for p in groups]
        c_ins = [None] * len(groups) if cache is None \
            else [_index(c, g) for c in cache]
        args = (x, aux, gp, cfg, positions, cross_emb, c_ins, cache_index,
                decode)
        x, aux, new_caches = checkpoint(_under_mesh(_run_group), *args,
                                        **_CKPT) \
            if remat else _run_group(*args)
        if collect_cache:
            for li, nc in enumerate(new_caches):
                collected[li].append(nc)
    if decode:
        return x, aux, cache
    if collect_cache:
        return x, aux, tuple(_stack(c) for c in collected)
    return x, aux, None


# ----------------------------------------------------------------------
# Encoder (enc-dec archs; non-causal self attention over frame embeddings)
# ----------------------------------------------------------------------

def _encoder_layer(x, bp, cfg: ModelConfig, mask):
    """One encoder layer: non-causal self attention (plain ``_sdpa``, no
    rope, no kernel, as in the reference) and the MLP."""
    h = apply_norm(x, bp["ln1"], cfg)
    x = x + encoder_attention(h, bp["attn"], cfg, mask)
    return x + apply_mlp(apply_norm(x, bp["ln2"], cfg), bp["mlp"], cfg)


def _encode(params, cfg: ModelConfig, enc_emb):
    """enc_emb (B, L, D) -> the encoder's output (B, L, D): every layer
    (each a checkpoint region under :func:`_remat`), then the encoder's
    final norm."""
    B, L, _ = enc_emb.shape
    mask = torch.ones((B, 1, L, L), dtype=torch.bool, device=enc_emb.device)
    (stacked,) = params["encoder"]["groups"]
    remat = _remat(cfg)
    x = enc_emb
    for i in range(cfg.n_enc_layers):
        args = (x, _index(stacked, i), cfg, mask)
        x = checkpoint(_under_mesh(_encoder_layer), *args, **_CKPT) \
            if remat else _encoder_layer(*args)
    return apply_norm(x, params["encoder"]["final_norm"], cfg)


# ----------------------------------------------------------------------
# Forward / prefill
# ----------------------------------------------------------------------

def _vocab_range(width: int, cfg: ModelConfig):
    """``(lo, split)``: the first vocab id of a head or embedding block of
    ``width`` ids, and whether the block is this rank's tile of a
    vocab-parallel split (then ``lo = s·width``)."""
    if width == cfg.padded_vocab:
        return 0, False
    s, _ = tp_rank_count()
    return s * width, True


def _embed(params, cfg: ModelConfig, tokens):
    dt = torch_dtype(cfg.dtype)
    emb = params["embed"]
    lo, split = _vocab_range(emb.shape[0], cfg)
    if split:
        local = tokens - lo
        mine = (local >= 0) & (local < emb.shape[0])
        x = torch.where(mine[..., None],
                        emb[local.clamp(0, emb.shape[0] - 1)],
                        emb.new_zeros(()))
        x = reduce_from_model(x).to(dt)
    else:
        x = emb[tokens].to(dt)
    if cfg.norm == "rmsnorm":
        # sqrt(d_model) rounded to the activation dtype first, as the
        # reference's jnp.sqrt(d).astype(dtype)
        x = x * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(dt)
    return x


def apply(params, cfg: ModelConfig, tokens, *, enc_emb=None, cross_emb=None,
          positions=None, want_cache=False):
    """Full-sequence forward.  Returns dict(hidden, aux, cache?).
    enc-dec archs take the frame embeddings ``enc_emb`` (B, L, D) through
    the encoder; VLMs take the patch embeddings ``cross_emb``."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int64,
                                 device=tokens.device).expand(B, S)
    x = _embed(params, cfg, tokens)
    dt = torch_dtype(cfg.dtype)
    if cfg.is_enc_dec:
        if enc_emb is None:
            raise ValueError(f"{cfg.name}: an enc-dec arch needs enc_emb")
        cross_emb = _encode(params, cfg, enc_emb.to(dt))
    elif cross_emb is not None:
        cross_emb = cross_emb.to(dt)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    prelude_cache = []
    for bp in params.get("prelude", []):
        x, nc, a = _run_block(x, bp, ("attn", "mlp"), cfg, positions,
                              cross_emb, None, None)
        prelude_cache.append(nc)
        if a is not None:
            aux_total = aux_total + a
    x, aux, cache = _scan_groups(x, params["groups"], cfg, positions,
                                 cross_emb, None, None, decode=False,
                                 collect_cache=want_cache)
    x = apply_norm(x, params["final_norm"], cfg)
    out = {"hidden": x, "aux": aux_total + aux}
    if want_cache:
        out["cache"] = {"prelude": prelude_cache, "groups": cache}
    return out


def _mask_pad_logits(lg, cfg: ModelConfig, lo: int = 0):
    """Pad columns to -1e30; ``lg``'s columns are vocab ids ``lo`` on."""
    if cfg.padded_vocab == cfg.vocab_size:
        return lg
    col = torch.arange(lo, lo + lg.shape[-1], device=lg.device)
    return torch.where(col < cfg.vocab_size, lg, -1e30)


def _head(params):
    w = params.get("lm_head")
    return params["embed"].T if w is None else w


def logits(params, cfg: ModelConfig, hidden):
    """fp32 logits (..., padded_vocab); the pad columns are -1e30.  A
    vocab-parallel head computes the rank's block and gathers the rest."""
    w = _head(params)
    lo, split = _vocab_range(w.shape[-1], cfg)
    if not split:
        return _mask_pad_logits(hidden.float() @ w.float(), cfg)
    lg = _mask_pad_logits(copy_to_model(hidden).float() @ w.float(), cfg, lo)
    return gather_tile(lg, -1, same_grad=True)


# ----------------------------------------------------------------------
# Loss: cross entropy in token chunks (never all logits at once)
# ----------------------------------------------------------------------

def lm_loss(params, cfg: ModelConfig, hidden, targets, mask):
    """hidden: (B,S,D); targets/mask: (B,S).  Vocab-parallel: each rank's
    log-sum-exp of its block, the group's gathered and combined the same
    way on every rank; the target logit summed from its one owner."""
    B, S, D = hidden.shape
    w = _head(params).float()                                 # (D, V)
    lo, split = _vocab_range(w.shape[-1], cfg)
    T = B * S
    h = hidden.reshape(T, D)
    if split:
        h = copy_to_model(h)
    t = targets.reshape(T)
    m = mask.reshape(T).float()
    Q = min(cfg.loss_chunk, T)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, T, Q):
        lg = _mask_pad_logits(shard(h[s0:s0 + Q].float() @ w,
                                    (None, "model")), cfg, lo)
        lse = torch.logsumexp(lg, dim=-1)
        ti = t[s0:s0 + Q] - lo
        if split:
            mine = (ti >= 0) & (ti < lg.shape[-1])
            ti = ti.clamp(0, lg.shape[-1] - 1)
        correct = torch.gather(lg, 1, ti[:, None])[:, 0]
        if split:
            lse = torch.logsumexp(gather_tile(lse[None], 0, same_grad=True),
                                  dim=0)
            correct = reduce_from_model(torch.where(mine, correct, 0.0))
        total = total + torch.sum((lse - correct) * m[s0:s0 + Q])
    return total / torch.clamp_min(m.sum(), 1.0)


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: {"tokens": (B,S), optional "enc_emb"/"cross_emb"/"mask"}."""
    tokens = batch["tokens"]
    out = apply(params, cfg, tokens, enc_emb=batch.get("enc_emb"),
                cross_emb=batch.get("cross_emb"))
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    mask = batch.get("mask")
    mask = torch.ones_like(tokens) if mask is None else mask.clone()
    mask[:, -1] = 0
    return lm_loss(params, cfg, out["hidden"], targets, mask) + out["aux"]


# ----------------------------------------------------------------------
# Decode (single token against a cache)
# ----------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: DeviceLike = None):
    """Zero cache matching the layout (group leaves lead with n_groups).
    A cross layer's entry holds its K/V over the ``cfg.cross_len``
    embeddings, which decode reads and never recomputes: the caller fills
    them (a prefill's cache, or ``make_cross_kv``).  On a model axis > 1
    it holds the rank's KV heads and Mamba channels, as the split layers
    write them."""
    dev = resolve_device(device)
    K, dh = kv_heads(cfg), cfg.head_dim
    dt = torch_dtype(cfg.dtype)

    def entry_cache(entry, lead):
        mixer, _ = entry
        if mixer in ("attn", "swa"):
            C = cache_len if mixer == "attn" else min(cfg.window, cache_len)
            shape = lead + (batch, C, K, dh)
            return {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}
        if mixer == "mamba":
            return init_mamba_cache(cfg, batch, dev, lead)
        if mixer in ("xattn", "attn_x"):
            shape = lead + (batch, cfg.cross_len, K, dh)
            cross = {"k": torch.zeros(shape, dtype=dt, device=dev),
                     "v": torch.zeros(shape, dtype=dt, device=dev)}
            if mixer == "xattn":
                return {"cross": cross}
            return {"self": entry_cache(("attn", None), lead),
                    "cross": cross}
        raise ValueError(mixer)

    cache = {"groups": tuple(entry_cache(e, (cfg.n_groups,))
                             for e in cfg.layout)}
    if cfg.first_k_dense:
        cache["prelude"] = [entry_cache(("attn", "mlp"), ())
                            for _ in range(cfg.first_k_dense)]
    return cache


def decode_step(params, cfg: ModelConfig, token, cache, cache_index):
    """token: (B,1) integer; cache_index: the absolute position, an int
    or a 0-d integer tensor (never read on the host, so a step on the card
    does not wait for it).

    Returns (logits (B,1,V), new_cache).  The cache is updated IN PLACE
    and new_cache holds the same tensors: the reference donates it."""
    B = token.shape[0]
    t = cache_index
    if isinstance(t, torch.Tensor):
        positions = torch.zeros((B, 1), dtype=torch.int64,
                                device=token.device) + t
    else:
        positions = torch.full((B, 1), int(t), dtype=torch.int64,
                               device=token.device)
    x = _embed(params, cfg, token)
    new_prelude = []
    for bp, pc in zip(params.get("prelude", []), cache.get("prelude", [])):
        x, nc, _ = _run_block(x, bp, ("attn", "mlp"), cfg, positions, None,
                              pc, t)
        _write_into(pc, nc)
        new_prelude.append(pc)
    x, _, new_groups = _scan_groups(x, params["groups"], cfg, positions,
                                    None, cache["groups"], t, decode=True)
    x = apply_norm(x, params["final_norm"], cfg)
    lg = shard(logits(params, cfg, x), (None, None, "model"))
    new_cache = {"groups": new_groups}
    if new_prelude:
        new_cache["prelude"] = new_prelude
    return lg, new_cache
