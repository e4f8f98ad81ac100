"""Attention of the zoo: GQA/MQA causal self attention (full or sliding
window), the blockwise long-sequence path, the flash-kernel route,
single-token decode against a KV cache (a ring buffer for sliding-window
layers) and cross attention over frontend or encoder embeddings (the
``xattn``/``attn_x`` mixers).  The counterpart of
``repro/models/attention.py``.
"""
from __future__ import annotations

import math

import torch

from ..sharding.api import shard
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
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    q = shard(q, (None, None, "model", None))
    k = (x @ p["wk"]).reshape(B, S, K, dh)
    v = (x @ p["wv"]).reshape(B, S, K, dh)
    k = rope(k, positions, cfg.rope_theta)
    q = rope(q, positions, cfg.rope_theta)

    if cache is None:
        if cfg.use_kernels and S > cfg.attn_direct_max:
            from ..kernels import ops as kops
            o = kops.flash_attention(q, k, v, window=window,
                                     softcap=cfg.logit_softcap)
        elif S <= cfg.attn_direct_max:
            mask = _causal_mask(positions, positions, window)
            o = _sdpa(q, k, v, mask, cfg.logit_softcap)
        else:
            o = _blockwise(q, k, v, positions, positions, window,
                           cfg.attn_chunk, cfg.logit_softcap)
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
        o = _sdpa(q, ck, cv, mask, cfg.logit_softcap)
        new_cache = {"k": ck, "v": cv}

    out = o.reshape(B, S, H * dh) @ p["wo"]
    return out, new_cache



# ----------------------------------------------------------------------
# Cross attention (VLM image layers, Whisper enc-dec)
# ----------------------------------------------------------------------

def cross_attention(x, p, cfg: ModelConfig, cross_kv):
    """cross_kv: {"k": (B,L,K,dh), "v": (B,L,K,dh)} (computed once from
    the frontend embeddings or the encoder output; static during decode).
    Plain ``_sdpa`` under an all-true (B, 1, S, L) mask, no rope, as in
    the reference: no kernel runs here."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    q = shard(q, (None, None, "model", None))
    L = cross_kv["k"].shape[1]
    mask = torch.ones((B, 1, S, L), dtype=torch.bool, device=x.device)
    o = _sdpa(q, cross_kv["k"], cross_kv["v"], mask, cfg.logit_softcap)
    return o.reshape(B, S, H * dh) @ p["wo"]


def make_cross_kv(emb, p, cfg: ModelConfig):
    """Project frontend/encoder embeddings (B, L, D) once into cross K/V."""
    B, L, _ = emb.shape
    K, dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": (emb @ p["wk"]).reshape(B, L, K, dh),
            "v": (emb @ p["wv"]).reshape(B, L, K, dh)}
