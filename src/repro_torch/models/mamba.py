"""Mamba-1 selective-state-space block (the falcon-mamba and Jamba mixer).
The counterpart of ``repro/models/mamba.py``.

Forward: depthwise causal conv, then the selective scan, in one of two
routes:

- plain (``cfg.use_kernels`` off): the scan runs in chunks of
  ``SCAN_CHUNK`` steps carrying the state, with a log-step (Hillis-Steele)
  scan inside each chunk, as the reference's ``lax.scan`` over an
  associative scan; the chunking bounds the (B, chunk, d_inner, d_state)
  working set;
- kernel (``cfg.use_kernels`` on): ``kernels.ops.mamba_scan``, the CUDA
  kernel on the card.  It exports the scan's final state too, so the
  prefill cache holds the state that the reference's plain path defines.
  The reference's kernel path hands decode a zero state instead
  (``repro/models/mamba.py:120-121``); the port does not copy that.

Decode: one O(1) step carrying (conv_state, ssm_state).

On a model axis ms > 1 that tiles ``d_inner`` the mixer is
channel-parallel: ``conv_w``, ``conv_b``, ``dt_proj``, ``dt_bias``,
``A_log`` and ``D_skip`` hold the rank's ``d_inner/ms`` channels, the scan
runs on them, ``x_proj`` and ``out_proj`` are row-parallel (each one
``all_reduce``), and the cache holds the rank's channels.  ``in_proj``'s
tile is a contiguous block of its ``2·d_inner`` columns, not the rank's
``x`` and ``z`` channels, so it is gathered (``sharding.col_blocks``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.api import (col_blocks, copy_to_model, reduce_from_model,
                            shard, tp_rank_count, whole_leaf)
from .config import ModelConfig, torch_dtype
from .layers import _const, _fill, dense_init

SCAN_CHUNK = 256


def make_mamba_params(gen, cfg: ModelConfig, device, lead=()):
    D, di, R, S, dc = (cfg.d_model, cfg.d_inner, cfg.dt_rank,
                       cfg.ssm_state, cfg.ssm_conv)
    pd = cfg.param_dtype
    lead = tuple(lead)
    dt_bias = torch.empty(lead + (di,), dtype=torch.float32, device=device)

    def draw_dt_bias():
        u = torch.rand((di,), generator=gen, dtype=torch.float32,
                       device=device) * (1e-1 - 1e-3) + 1e-3
        return torch.log(torch.expm1(u.clamp_min(1e-4)))

    A = torch.arange(1, S + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, (D, 2 * di), pd, device, lead=lead),
        "conv_w": dense_init(gen, (dc, di), pd, device, fan_in=dc,
                             lead=lead),
        "conv_b": _const(0.0, (di,), pd, device, lead),
        "x_proj": dense_init(gen, (di, R + 2 * S), pd, device, lead=lead),
        "dt_proj": dense_init(gen, (R, di), pd, device, lead=lead),
        "dt_bias": _fill(dt_bias, lead, draw_dt_bias),
        "A_log": torch.log(A).expand(lead + (di, S)).contiguous(),
        "D_skip": _const(1.0, (di,), torch.float32, device, lead),
        "out_proj": dense_init(gen, (di, D), pd, device, fan_in=di,
                               lead=lead),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv by shifted adds.  x: (B,S,di), w: (dc,di)."""
    dc = w.shape[0]
    out = x * w[-1]
    for j in range(1, dc):
        shifted = F.pad(x, (0, 0, j, 0))[:, :-j, :]
        out = out + shifted * w[dc - 1 - j]
    return out + b


def channel_split(cfg: ModelConfig, p=None):
    """This rank's channels ``(lo, hi)`` of ``d_inner`` when the mixer is
    channel-parallel (a model axis > 1 that tiles it, ``out_proj`` in
    ``p`` this rank's rows), else None."""
    s, ms = tp_rank_count()
    di = cfg.d_inner
    if ms <= 1 or di % ms or (p is not None
                              and p["out_proj"].shape[-2] == di):
        return None
    return s * di // ms, (s + 1) * di // ms


def _ssm_coeffs(xc, p, cfg: ModelConfig):
    """xc: (B,S,di) post-conv activations -> (deltaA, deltaBx, Cmat), the
    first two (B,S,di,n) fp32, the last (B,S,n) fp32.  Channel-parallel,
    ``x_proj``'s rows are the rank's: the projection is summed over the
    group, and re-enters the split for the rank's channels."""
    R, S_st = cfg.dt_rank, cfg.ssm_state
    proj = xc @ p["x_proj"]                                    # (B,S,R+2n)
    if channel_split(cfg, p) is not None:
        proj = copy_to_model(reduce_from_model(proj))
    dt_r, Bm, Cm = torch.split(proj, [R, S_st, S_st], dim=-1)
    dt = F.softplus(dt_r.float() @ p["dt_proj"].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                 # (di,n)
    dA = torch.exp_(dt[..., None] * A)                         # (B,S,di,n)
    dBx = (dt * xc.float())[..., None] * Bm[:, :, None, :].float()
    return dA, dBx, Cm.float().contiguous()      # Cm: a view of the split


def _chunk_scan(dA, dBx, h0):
    """Scan within a chunk from the entry state h0:
    h_t = dA_t * h_{t-1} + dBx_t.  A log-step inclusive scan of the pairs
    (dA, dBx) under (a, b) -> (a0 b0, b0 a1 + b1), then h = A h0 + B.
    Returns (h_all (B,Q,di,n), h_last)."""
    A, Bv = dA, dBx
    Q = A.shape[1]
    off = 1
    while off < Q:
        A_new, B_new = A.clone(), Bv.clone()
        A_new[:, off:] = A[:, off:] * A[:, :-off]
        B_new[:, off:] = A[:, off:] * Bv[:, :-off] + Bv[:, off:]
        A, Bv = A_new, B_new
        off *= 2
    h_all = A * h0[:, None] + Bv
    return h_all, h_all[:, -1]


def _plain_scan(dA, dBx, Cm):
    """The reference's plain scan: chunks of SCAN_CHUNK carrying the
    state (dA padded with 1, dBx with 0).  -> (y (B,S,di), h_last)."""
    B, S, di, n = dA.shape
    Q = min(SCAN_CHUNK, S)
    h = torch.zeros((B, di, n), dtype=torch.float32, device=dA.device)
    ys = []
    for s0 in range(0, S, Q):
        da, dbx = dA[:, s0:s0 + Q], dBx[:, s0:s0 + Q]
        pad = Q - da.shape[1]
        if pad:
            da = F.pad(da, (0, 0, 0, 0, 0, pad), value=1.0)
            dbx = F.pad(dbx, (0, 0, 0, 0, 0, pad))
        h_all, h = _chunk_scan(da, dbx, h)
        h_all = h_all[:, :Q - pad]
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, Cm[:, s0:s0 + Q]))
    return torch.cat(ys, dim=1), h


def mamba_mixer(x, p, cfg: ModelConfig, cache=None, cache_index=None):
    """x: (B,S,D).  Returns (out, new_cache).

    cache: {"conv": (B,dc,di), "ssm": (B,di,n)} for decode, else None.
    The forward's new_cache holds the last dc inputs of the conv and the
    scan's final state, on both routes.
    """
    B, S, _ = x.shape
    dc, di = cfg.ssm_conv, cfg.d_inner
    ch = channel_split(cfg, p)
    if ch is None:
        xz = shard(x @ whole_leaf(p["in_proj"], 2 * di), (None, None, "model"))
        xp, z = torch.chunk(xz, 2, dim=-1)
    else:
        x = copy_to_model(x)
        lo, hi = ch
        w_x, w_z = col_blocks(p["in_proj"], 2 * di,
                              [(lo, hi), (di + lo, di + hi)])
        xp, z = x @ w_x, x @ w_z

    if cache is None:
        xc = F.silu(_causal_conv(xp, p["conv_w"], p["conv_b"]))
        if cfg.use_kernels:
            from ..kernels import ops as kops
            y, h_last = kops.mamba_scan(xc, p, cfg)
        else:
            y, h_last = _plain_scan(*_ssm_coeffs(xc, p, cfg))
        y = y + p["D_skip"] * xc.float()
        conv_state = F.pad(xp, (0, 0, max(dc - S, 0), 0))[:, -dc:, :]
        new_cache = {"conv": conv_state, "ssm": h_last}
    else:
        conv_state = torch.cat([cache["conv"][:, 1:, :], xp], dim=1)
        xc = F.silu(
            torch.einsum("bcd,cd->bd", conv_state.float(),
                         p["conv_w"].float())
            + p["conv_b"].float())[:, None, :].to(x.dtype)
        dA, dBx, Cm = _ssm_coeffs(xc, p, cfg)
        h = dA[:, 0] * cache["ssm"] + dBx[:, 0]                # (B,di,n)
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :]
        y = y + p["D_skip"] * xc.float()
        new_cache = {"conv": conv_state, "ssm": h}

    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    if ch is not None:
        out = reduce_from_model(out)
    return out, new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, device, lead=()):
    """Zero conv and SSM states: the rank's channels on a split."""
    lead = tuple(lead)
    ch = channel_split(cfg)
    di = cfg.d_inner if ch is None else ch[1] - ch[0]
    return {"conv": torch.zeros(lead + (batch, cfg.ssm_conv, di),
                                dtype=torch_dtype(cfg.dtype), device=device),
            "ssm": torch.zeros(lead + (batch, di, cfg.ssm_state),
                               dtype=torch.float32, device=device)}

