"""Attention of the zoo: GQA/MQA causal self attention (full or sliding
window), the blockwise long-sequence path, the flash-kernel route,
single-token decode against a KV cache (a ring buffer for sliding-window
layers) and cross attention over frontend or encoder embeddings (the
``xattn``/``attn_x`` mixers).  The counterpart of
``repro/models/attention.py``.

On a model axis ms > 1 that tiles ``H·dh`` the heads split over the model
group (:func:`head_plan`): ``wo``'s tile holds rows ``[a, b)`` of the
``H·dh`` head columns, so the rank computes the heads that cover them
(its ``H/ms`` heads when ``ms | H``), the KV heads those read, and adds
``o[:, :, a:b] @ wo`` into one ``all_reduce``.  A ``wq``/``wk``/``wv``
tile that cuts a head, or holds other heads than the rank needs (``K %
ms != 0``: gemma-2b's and granite's single KV head), is gathered
(``sharding.col_blocks``).  The KV cache holds the rank's KV heads.
"""
from __future__ import annotations

import math

import torch

from ..sharding.api import (col_blocks, copy_to_model, reduce_from_model,
                            shard, tp_rank_count, whole_leaf)
from .config import ModelConfig
from .layers import dense_init

NEG_INF = -2.0 ** 30


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Half-split rotary embedding.  x: (B, S, H, dh); positions: (B, S)
    integers; the angles are fp32."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq      # (B, S, half)
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------------
# Params
# ----------------------------------------------------------------------

def make_attn_params(gen, cfg: ModelConfig, device, lead=()):
    """wq, wk, wv, wo; a cross attention block has the same leaves."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    pd = cfg.param_dtype
    return {"wq": dense_init(gen, (d, h * hd), pd, device, lead=lead),
            "wk": dense_init(gen, (d, kv * hd), pd, device, lead=lead),
            "wv": dense_init(gen, (d, kv * hd), pd, device, lead=lead),
            "wo": dense_init(gen, (h * hd, d), pd, device, fan_in=h * hd,
                             lead=lead)}


# ----------------------------------------------------------------------
# Core softmax attention on explicit q, k, v
# ----------------------------------------------------------------------

def _sdpa(q, k, v, mask, softcap=None):
    """q: (B,Sq,H,dh)  k,v: (B,Sk,K,dh)  mask: broadcastable (B,1,Sq,Sk)
    bool.  Scores and softmax in fp32; masked scores take the finite
    NEG_INF, as in the reference."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    g = H // K
    qf = q.reshape(B, Sq, K, g, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    s = s / math.sqrt(dh)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[:, :, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, dh).to(v.dtype)


def _causal_mask(q_pos, k_pos, window):
    """q_pos: (B,Sq), k_pos: (B,Sk) -> (B,1,Sq,Sk) bool."""
    m = k_pos[:, None, None, :] <= q_pos[:, None, :, None]
    if window is not None:
        m &= k_pos[:, None, None, :] > (q_pos[:, None, :, None] - window)
    return m


def _blockwise(q, k, v, q_pos, k_pos, window, chunk, softcap=None):
    """Attention one q chunk at a time (the reference's XLA path for long
    sequences).  For sliding-window layers each chunk reads only a
    (chunk + window) slice of k/v, so compute is O(S * window)."""
    B, S, H, dh = q.shape
    pad = (-S) % chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad), value=-1)
    n_chunks = q.shape[1] // chunk
    Sk = k.shape[1]
    use_slice = window is not None and (chunk + window) < Sk
    span = chunk + window if use_slice else Sk
    outs = []
    for i in range(n_chunks):
        qi = q[:, i * chunk:(i + 1) * chunk]
        pi = q_pos[:, i * chunk:(i + 1) * chunk]
        if use_slice:
            start = min(max(i * chunk - window, 0), Sk - span)
            ki = k[:, start:start + span]
            vi = v[:, start:start + span]
            kpi = k_pos[:, start:start + span]
        else:
            ki, vi, kpi = k, v, k_pos
        mask = _causal_mask(pi, kpi, window) & (pi[:, None, :, None] >= 0)
        outs.append(_sdpa(qi, ki, vi, mask, softcap))
    return torch.cat(outs, dim=1)[:, :S]


# ----------------------------------------------------------------------
# The heads of a model rank
# ----------------------------------------------------------------------

def head_plan(cfg: ModelConfig, p=None):
    """This model rank's share of the heads, or None when they do not
    split: no model axis > 1, ``ms`` does not tile ``H·dh`` (every leaf is
    whole then but a tiled ``wk``/``wv``), or the block's ``wo`` in ``p``
    is whole (params not placed: every rank runs the whole block).
    -> ``(h0, h1, k0, k1, a, b, expand)``: query heads ``[h0, h1)``, KV
    heads ``[k0, k1)``, the rank's ``o`` columns ``[a, b)`` counted from
    head ``h0``'s first, and ``expand`` (None, or each local query head's
    local KV head when the GQA grouping does not carry over)."""
    s, ms = tp_rank_count()
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if ms <= 1 or (H * dh) % ms or (p is not None
                                    and p["wo"].shape[-2] == H * dh):
        return None
    a, b = s * H * dh // ms, (s + 1) * H * dh // ms
    h0, h1 = a // dh, -(-b // dh)
    g = H // K
    k0, k1 = h0 // g, (h1 - 1) // g + 1
    expand = None
    if not ((h0 % g == 0 and (h1 - h0) % g == 0) or k1 - k0 == 1):
        expand = [h // g - k0 for h in range(h0, h1)]
    return h0, h1, k0, k1, a - h0 * dh, b - h0 * dh, expand


def kv_heads(cfg: ModelConfig) -> int:
    """The KV heads a rank computes and caches, its params placed."""
    plan = head_plan(cfg)
    return cfg.n_kv_heads if plan is None else plan[3] - plan[2]


def _q_proj(x, p, cfg: ModelConfig, plan):
    """The rank's query heads (B, S, heads, dh) of ``x``, which has entered
    the model-parallel region when ``plan`` is set.  Without a split
    ``wq`` is whole: it tiles exactly where ``wo`` does."""
    H, dh = cfg.n_heads, cfg.head_dim
    if plan is None:
        w, n = p["wq"], H
    else:
        (w,) = col_blocks(p["wq"], H * dh, [(plan[0] * dh, plan[1] * dh)])
        n = plan[1] - plan[0]
    B, S, _ = x.shape
    return (x @ w).reshape(B, S, n, dh)


def _kv_proj(x, p, cfg: ModelConfig, plan):
    """The rank's K and V heads of ``x`` (B, L, D)."""
    K, dh = cfg.n_kv_heads, cfg.head_dim
    B, L, _ = x.shape
    if plan is None:
        wk, wv, n = whole_leaf(p["wk"], K * dh), whole_leaf(p["wv"], K * dh), K
    else:
        cols = [(plan[2] * dh, plan[3] * dh)]
        (wk,), (wv,) = (col_blocks(p[w], K * dh, cols) for w in ("wk", "wv"))
        n = plan[3] - plan[2]
    return (x @ wk).reshape(B, L, n, dh), (x @ wv).reshape(B, L, n, dh)


def _grouped(k, plan):
    """K or V heads as the rank's query heads read them."""
    if plan is None or plan[6] is None:
        return k
    return k[:, :, torch.tensor(plan[6], device=k.device)]


def _out_proj(o, p, cfg: ModelConfig, plan):
    """o (B, S, heads, dh) -> the block's output: ``o @ wo``, or this
    rank's columns ``[a, b)`` times its ``wo`` rows, summed over the
    group."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, -1)
    if plan is None:
        return o @ p["wo"]
    return reduce_from_model(o[:, :, plan[4]:plan[5]] @ p["wo"])


def _enter(x, plan):
    return x if plan is None else copy_to_model(x)


# ----------------------------------------------------------------------
# Self attention block (forward / prefill / decode)
# ----------------------------------------------------------------------

def self_attention(x, p, cfg: ModelConfig, positions, window=None,
                   cache=None, cache_index=None):
    """Returns (out, new_cache).  cache: {"k": (B,C,K,dh), "v": ...} or
    None.

    - cache is None            -> forward; new_cache is the (k, v) computed.
    - cache given, x is 1 tok  -> decode at absolute position
      ``cache_index`` (an int, or a 0-d integer tensor, which is never
      read on the host): k and v are written into the cache IN PLACE (at
      ``cache_index % C`` for a sliding-window ring buffer), and
      new_cache holds the same tensors.  The reference donates the cache
      to its decode step, so nothing reads the old contents.
    """
    B, S, _ = x.shape
    plan = head_plan(cfg, p)
    x = _enter(x, plan)
    q = shard(_q_proj(x, p, cfg, plan), (None, None, "model", None))
    k, v = _kv_proj(x, p, cfg, plan)
    k = rope(k, positions, cfg.rope_theta)
    q = rope(q, positions, cfg.rope_theta)

    if cache is None:
        if cfg.use_kernels and S > cfg.attn_direct_max:
            from ..kernels import ops as kops
            o = kops.flash_attention(q, _grouped(k, plan),
                                     _grouped(v, plan), window=window,
                                     softcap=cfg.logit_softcap)
        elif S <= cfg.attn_direct_max:
            mask = _causal_mask(positions, positions, window)
            o = _sdpa(q, _grouped(k, plan), _grouped(v, plan), mask,
                      cfg.logit_softcap)
        else:
            o = _blockwise(q, _grouped(k, plan), _grouped(v, plan),
                           positions, positions, window, cfg.attn_chunk,
                           cfg.logit_softcap)
        new_cache = {"k": k, "v": v}
    else:
        t = cache_index
        ck, cv = cache["k"], cache["v"]
        C = ck.shape[1]
        slot = t % C if window is not None else t
        if isinstance(t, torch.Tensor):
            at = torch.arange(S, dtype=torch.int64, device=x.device) + slot
            ck.index_copy_(1, at, k.to(ck.dtype))
            cv.index_copy_(1, at, v.to(cv.dtype))
        else:
            ck[:, slot:slot + S] = k
            cv[:, slot:slot + S] = v
        idx = torch.arange(C, dtype=torch.int64, device=x.device)[None, :]
        if window is not None:
            # entry idx holds the largest position p <= t with p % C == idx
            k_pos = (t - torch.remainder(t - idx, C)).expand(B, C)
        else:
            k_pos = idx.expand(B, C)
        valid = (k_pos <= positions[:, :1]) & (k_pos >= 0)
        mask = _causal_mask(positions, k_pos, window) & \
            valid[:, None, None, :]
        o = _sdpa(q, _grouped(ck, plan), _grouped(cv, plan), mask,
                  cfg.logit_softcap)
        new_cache = {"k": ck, "v": cv}

    return _out_proj(o, p, cfg, plan), new_cache



# ----------------------------------------------------------------------
# Cross attention (VLM image layers, Whisper enc-dec)
# ----------------------------------------------------------------------

def cross_attention(x, p, cfg: ModelConfig, cross_kv):
    """cross_kv: {"k": (B,L,K,dh), "v": (B,L,K,dh)} (computed once from
    the frontend embeddings or the encoder output; static during decode;
    the rank's KV heads on a split).  Plain ``_sdpa`` under an all-true
    (B, 1, S, L) mask, no rope, as in the reference: no kernel runs
    here."""
    B, S, _ = x.shape
    plan = head_plan(cfg, p)
    q = _q_proj(_enter(x, plan), p, cfg, plan)
    q = shard(q, (None, None, "model", None))
    L = cross_kv["k"].shape[1]
    mask = torch.ones((B, 1, S, L), dtype=torch.bool, device=x.device)
    o = _sdpa(q, _grouped(cross_kv["k"], plan), _grouped(cross_kv["v"], plan),
              mask, cfg.logit_softcap)
    return _out_proj(o, p, cfg, plan)


def make_cross_kv(emb, p, cfg: ModelConfig):
    """Project frontend/encoder embeddings (B, L, D) once into cross K/V
    (the rank's KV heads on a split)."""
    plan = head_plan(cfg, p)
    k, v = _kv_proj(_enter(emb, plan), p, cfg, plan)
    return {"k": k, "v": v}


def encoder_attention(x, p, cfg: ModelConfig, mask):
    """Non-causal self attention over frame embeddings (plain ``_sdpa``,
    no rope, no kernel, as in the reference)."""
    plan = head_plan(cfg, p)
    xin = _enter(x, plan)
    q = _q_proj(xin, p, cfg, plan)
    k, v = _kv_proj(xin, p, cfg, plan)
    o = _sdpa(q, _grouped(k, plan), _grouped(v, plan), mask,
              cfg.logit_softcap)
    return _out_proj(o, p, cfg, plan)
